#!/usr/bin/env python3
"""Attribute the time of the `fused_tile_candidates` and `ann_gather_scan`
CUDA kernels on one card.

    python3 scripts/fused_probe.py [--kernel fused|ann|all] [--variants all|none|name,...]

fused: times the kernel (CUDA events, `chip_smoke.time_ms`) at the C1 chunk
of `chip_smoke.py`'s kernels_fused phase (Qc=512, N=1M, the [896, N]
split-bf16 tier, Td=4, ~1.5M window entries, t=7), through the wrapper's
own route and through each route the wrapper has ("sort" is the previous
design, one block per (row, tile) with a bitonic sort of the tile).

ann: times the kernel at bench.py C4's batch (1M x 384 clustered vectors
through build_ann on the card, 1,024 queries, nprobe 2, kb=100, cosine),
int8 and bf16.

Then, for each kernel, it builds variants of the source, each with one
part of the kernel disabled by a text substitution, one nvcc each, all
started together, and times each the same way. A disabled part gives wrong
results: a variant measures where the time goes, nothing else. A variant
whose anchor text is not in the source (a part of another design) is
reported as skipped. Prints one line per timing and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> [(anchor, replacement)], each applied to csrc/<kernel>.cu or to the
# shared csrc/topk_select.cuh, whichever holds the anchor
FUSED_VARIANTS = {
    # the chunk-sort design (one 512-thread block per (row, tile))
    "sort_no_sparse": [("for (int p = a + threadIdx.x; p < b; p += THREADS) {",
                        "for (int p = a + threadIdx.x; p < a; p += THREADS) {")],
    "sort_no_dense": [("for (int i = 0; i < Td; ++i) {\n    const float wv",
                       "for (int i = 0; i < 0; ++i) {\n    const float wv")],
    "sort_no_sort": [("  sort_desc(tile_keys);\n  for (int s = threadIdx.x; s < t;",
                      "  for (int s = threadIdx.x; s < t;")],
    # the warp-selection design (a warp per row, 32 rows per block)
    "select_no_sparse": [("const bool in = lane >= used && idx < b &&",
                          "const bool in = lane >= used && idx < a &&")],
    "select_no_dense": [("        if (i < nw) {\n          hv[i] = load8_bf16(",
                         "        if (i < 0) {\n          hv[i] = load8_bf16("),
                        ("        if (i < nw) {\n#pragma unroll",
                         "        if (i < 0) {\n#pragma unroll"),
                        ("for (int x = rest; x < Td; ++x) {", "for (int x = rest; x < 0; ++x) {")],
    "select_no_fold": [("if (__any_sync(FULL, pass != 0u)) {\n          warp_fold(",
                        "if (N < 0 && __any_sync(FULL, pass != 0u)) {\n          warp_fold("),
                       ("          const unsigned m = __ballot_sync(FULL, pend != 0u);",
                        "          const unsigned m = __ballot_sync(FULL, N < 0 && pend != 0u);")],
}
ANN_VARIANTS = {
    # the previous design, per-(query, probe, chunk) blocks (csrc/
    # ann_gather_scan.cu at commit f93d27e): run this script with --kernel
    # ann from a checkout of that commit
    "chunk_no_staging": [("if (r < rows && dd < dn) {", "if (r < 0) {")],
    "chunk_no_dots": [("for (int dd = 0; dd < dn; ++dd) {", "for (int dd = 0; dd < 0; ++dd) {")],
    "chunk_no_select": [("  emit_chunk(keys, scratch, cnt, k, blk, cand, partial);",
                         "  if (tid < k) cand[blk * k + tid] = keys[tid];\n"
                         "  if (tid == 0) partial[blk] = cnt;")],
    "chunk_no_merge": [("  merge_row(cand, partial, nchunks, k, out_v, out_i, out_t);",
                        "  if (k < 0) merge_row(cand, partial, nchunks, k, out_v, out_i, out_t);")],
    # the tile-major design (grouped pairs, register tiles, warp selection)
    "tile_no_staging": [("  using GE = Geo<TIER>;\n  const int d0 = kt * GE::DK;",
                         "  using GE = Geo<TIER>;\n  if (a.D > 0) return;\n"
                         "  const int d0 = kt * GE::DK;")],
    "tile_no_dots": [("          if (!busy) continue;\n          const unsigned char* st",
                      "          continue;\n          const unsigned char* st")],
    "tile_no_select": [("if (__any_sync(FULL, pass != 0u))\n          warp_fold(",
                        "if (a.k < 0 && __any_sync(FULL, pass != 0u))\n          warp_fold(")],
    "tile_no_insert": [("constexpr int INSERT_MAX = 2;", "constexpr int INSERT_MAX = 0;")],
    "tile_fold_inline": [("__device__ __noinline__ void warp_fold(",
                          "__device__ __forceinline__ void warp_fold(")],
    # device counters of the warp selection: folds, folds by ranks, folds by
    # sort (the rest insert one or two keys), keys staged (read by
    # `probe_read_counts`)
    "tile_counts": [("constexpr int WARP_FOLD_SCR",
                     "__device__ unsigned long long probe_counts[4];\nconstexpr int WARP_FOLD_SCR"),
                    ("  if (staged <= INSERT_MAX) {\n",
                     "  if (lane == 0) {\n    atomicAdd(&probe_counts[0], 1ull);\n"
                     "    atomicAdd(&probe_counts[3], static_cast<unsigned long long>(staged));\n"
                     "    if (staged > MERGE_MAX) atomicAdd(&probe_counts[2], 1ull);\n"
                     "    else if (staged > INSERT_MAX) atomicAdd(&probe_counts[1], 1ull);\n"
                     "  }\n  if (staged <= INSERT_MAX) {\n"),
                    ('extern "C" {\n',
                     'extern "C" {\n\nvoid probe_read_counts(unsigned long long* out) {\n'
                     '  cudaMemcpyFromSymbol(out, probe_counts, sizeof(probe_counts));\n}\n\n'
                     'void probe_reset_counts() {\n  unsigned long long z[4] = {0, 0, 0, 0};\n'
                     '  cudaMemcpyToSymbol(probe_counts, z, sizeof(z));\n}\n\n')],
    "tile_no_merge": [("  select_merge_row(cand, partial, P * geo[1], k,",
                       "  if (k > 0) return;\n  select_merge_row(cand, partial, P * geo[1], k,")],
}


HEADER = "topk_select.cuh"


def _variant_source(srcs: dict, subs) -> dict | None:
    """({file name: text}, substitutions) -> the patched texts, or None
    when an anchor is in no file."""
    srcs = dict(srcs)
    for a, b in subs:
        hits = [name for name, text in srcs.items() if a in text]
        if not hits:
            return None
        srcs[hits[0]] = srcs[hits[0]].replace(a, b)
    return srcs


def _start_builds(kernel: str, variants: dict, names) -> tuple[dict, list]:
    """One nvcc per variant of csrc/<kernel>.cu, all started. -> ({name:
    (process, library path)}, [skipped names])."""
    from elasticsearch_tpu_torch.ops import _build

    src = {f: (_build.CSRC_DIR / f).read_text() for f in (f"{kernel}.cu", HEADER)}
    tmp = tempfile.mkdtemp(prefix=f"{kernel}_probe_")
    procs, skipped = {}, []
    for name in names:
        texts = _variant_source(src, variants[name])
        if texts is None:
            skipped.append(name)
            continue
        vdir = os.path.join(tmp, name)  # the variant's header shadows csrc/'s
        os.makedirs(vdir)
        for fname, text in texts.items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        path = os.path.join(vdir, f"{kernel}.cu")
        lib = os.path.join(tmp, f"{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    return procs, skipped


def _time_variants(kernel: str, procs: dict, skipped: list, timings: dict, dev) -> int:
    """Load each built variant in place of the package's library and time
    every entry of `timings` ({label: fn}) with it."""
    import torch

    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import _build

    for name in skipped:
        print(f"variant {name}: anchor not in the source, skipped")
    for name, (p, lib) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(f"variant {name}: build failed\n{out[-3000:]}")
            return 1
        so = _build._libs[kernel] = ctypes.CDLL(lib)
        for label, fn in timings.items():
            if hasattr(so, "probe_read_counts"):  # one call, counted
                counts = (ctypes.c_ulonglong * 4)()
                so.probe_reset_counts()
                fn()
                torch.cuda.synchronize()
                so.probe_read_counts(counts)
                print(f"variant {name}, {label}, one call: {counts[0]} folds, {counts[1]} by "
                      f"ranks, {counts[2]} by sort, {counts[3]} keys staged", flush=True)
                continue
            print(f"variant {name}, {label}: {cs.time_ms(fn, 3, dev):.4f} ms", flush=True)
    _build._libs.pop(kernel, None)  # the package's own build again
    return 0


def probe_fused(names, dev) -> int:
    import torch

    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import fused

    procs, skipped = _start_builds("fused_tile_candidates", FUSED_VARIANTS, names)
    gen = torch.Generator(device=dev).manual_seed(2)
    hi, lo, live = cs.c1_dense_tier(dev, 1_000_000, gen)
    c1 = cs.fused_c1_inputs(dev, np.random.default_rng(0), hi, lo, live)
    args, t, db = c1["args"], c1["t"], c1["db"]
    timings = {"C1 chunk": lambda: fused.fused_tile_candidates(*args, t=t, db=db)}
    for route in getattr(fused, "FUSED_ROUTES", ()):
        timings[f"C1 chunk, route {route}"] = (
            lambda r=route: fused._fused_tile_candidates_cuda(*args, t, db, route=r))
    for label, fn in timings.items():
        print(f"fused_tile_candidates, {label}: {cs.time_ms(fn, 3, dev):.4f} ms", flush=True)
    return _time_variants("fused_tile_candidates", procs, skipped, timings, dev)


def probe_ann(names, dev) -> int:
    import torch

    import chip_smoke as cs
    from elasticsearch_tpu_torch.ann import AnnSearcher, build_ann
    from elasticsearch_tpu_torch.ann.kernels import ann_gather_scan, centroid_topk
    from elasticsearch_tpu_torch.corpus import vector_corpus

    procs, skipped = _start_builds("ann_gather_scan", ANN_VARIANTS, names)
    n_vec, D = cs.KNN_VECTORS, 384
    nlist = max(16, int(n_vec ** 0.5 * 0.75))
    vecs, _ = vector_corpus(np.random.default_rng(0), n_vec, D, nlist, 64)
    ann = build_ann(vecs, np.ones(n_vec, bool), nlist, device=dev)
    searcher = AnnSearcher(ann, vecs, (vecs * vecs).sum(1), "cosine", device=dev)
    del vecs
    ad, ls = searcher.dev, searcher._slot_live()
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((cs.KNN_BATCH, D), generator=gen, device=dev)
    probes = centroid_topk(ad["centroids"], q, nprobe=2)
    print(f"C4 tiles: C={ad['order'].shape[0]} L={ad['order'].shape[1]}, "
          f"{torch.unique(probes).numel()} distinct tiles probed", flush=True)
    timings = {f"C4 batch {tier}": (lambda tier=tier: ann_gather_scan(
        q, probes, ad, ls, cs.KNN_NC, tier=tier)) for tier in ("int8", "bf16")}
    for label, fn in timings.items():
        print(f"ann_gather_scan, {label}: {cs.time_ms(fn, 3, dev):.4f} ms", flush=True)
    _search_split(dev)
    return _time_variants("ann_gather_scan", procs, skipped, timings, dev)


def _search_split(dev) -> None:
    """The `_search` shape (B=1, P=2, L=1,792, kb=100, int8, synthetic
    tiles of 316 clusters): the call's time and each device op's share of
    it under torch.profiler, over 100 calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from elasticsearch_tpu_torch.ann.kernels import ann_gather_scan

    gen = torch.Generator(device=dev).manual_seed(5)
    tiles = cs._synthetic_ann(gen, dev, 316, 1792, 384, 100_000)
    ls = (torch.rand(tiles["order"].shape, generator=gen, device=dev) > 0.1).to(torch.uint8)
    q = torch.randn((1, 384), generator=gen, device=dev)
    probes = torch.randperm(316, generator=gen, device=dev)[:2][None].to(torch.int32)

    def call():
        return ann_gather_scan(q, probes, tiles, ls, cs.KNN_NC)

    print(f"ann_gather_scan, _search shape B=1 P=2 L=1792: {cs.time_ms(call, 200, dev):.4f} ms",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            call()
        torch.cuda.synchronize()
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:8]:
        if e.self_device_time_total > 0:
            print(f"  _search shape device op {e.self_device_time_total / 100:.2f} us per call: "
                  f"{e.key[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("fused", "ann", "all"), default="all")
    ap.add_argument("--variants", default="all")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_probe: no CUDA card is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rc = 0
    for kernel, variants, probe in (("fused", FUSED_VARIANTS, probe_fused),
                                    ("ann", ANN_VARIANTS, probe_ann)):
        if args.kernel not in (kernel, "all"):
            continue
        names = {"all": list(variants), "none": []}.get(
            args.variants, [n for n in args.variants.split(",") if n in variants])
        rc = rc or probe(names, dev)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
