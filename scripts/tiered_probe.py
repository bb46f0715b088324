#!/usr/bin/env python3
"""Attribute the time of the `tiered_candidates` CUDA kernel on one card.

    python3 scripts/tiered_probe.py [--variants all|none|name,name,...] [--counts]

Times the kernel (CUDA events, `chip_smoke.time_ms`) at the k=25 `_msearch`
dense-only shape (B=512 BM25 query rows of 1-4 terms, D=896, N=1M, a 5%
dense split-bf16 tier, kb=64, identity, count_positive) and at C4's exact
arm (B=1024, D=384, cosine, standard normal), beside one bf16 cuBLAS
product of the msearch shape. Then it builds variants of
csrc/tiered_candidates.cu and of the selection header it includes, each
with one part of the kernel disabled or changed by a text substitution, one
nvcc each, all started together, and times each at both shapes. A disabled
part gives wrong results: the variants measure where the time goes, nothing
else. With --counts, one more build counts, in device atomics, the
epilogue's merges at both shapes:
the (row, half tile) merges, those by ranks (3 to 32 lanes), those by a
sort (more), and the lanes that beat a threshold. Prints one line per timing
or count and the card's name and power limit.
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

ROW_PASS = "for (int i = warp; i < BM; i += WARPS) {\n        if (r0 + i >= B) break;"
FOLD = "if (__any_sync(0xffffffffu, np > 0))"
VARIANTS = {
    # the epilogue's row pass (keys, counts, filter, folds) skipped
    "no_row_pass": [(ROW_PASS, ROW_PASS.replace("i < BM;", "i < 0;"))],
    # the row pass without the merges of the lanes that beat a threshold
    "no_fold": [(FOLD, "if (N < 0 && __any_sync(0xffffffffu, np > 0))")],
    # the merge inlined into the row pass
    "inline_fold": [("__device__ __noinline__ void warp_fold(", "__device__ void warp_fold(")],
    # every merge by the warp's bitonic sort; no insertion (ranks from one key)
    "sort_only": [("constexpr int INSERT_MAX = 2;", "constexpr int INSERT_MAX = 0;"),
                  ("constexpr int MERGE_MAX = 32;", "constexpr int MERGE_MAX = 0;")],
    "no_insert": [("constexpr int INSERT_MAX = 2;", "constexpr int INSERT_MAX = 0;")],
}
COUNTS = [  # device counters: merges, merges by ranks, merges by sort, lanes staged
    # (the rest of the merges insert one or two lanes)
    ("constexpr int WARP_FOLD_SCR",
     "__device__ unsigned long long probe_counts[4];\nconstexpr int WARP_FOLD_SCR"),
    ("  if (staged <= INSERT_MAX) {\n",
     "  if (lane == 0) {\n    atomicAdd(&probe_counts[0], 1ull);\n"
     "    atomicAdd(&probe_counts[3], static_cast<unsigned long long>(staged));\n"
     "    if (staged > MERGE_MAX) atomicAdd(&probe_counts[2], 1ull);\n"
     "    else if (staged > INSERT_MAX) atomicAdd(&probe_counts[1], 1ull);\n  }\n"
     "  if (staged <= INSERT_MAX) {\n"),
]
READ_COUNTS = """
extern "C" void probe_read_counts(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, probe_counts, sizeof(probe_counts));
}
extern "C" void probe_reset_counts() {
  unsigned long long z[4] = {0, 0, 0, 0};
  cudaMemcpyToSymbol(probe_counts, z, sizeof(z));
}
"""


def _variant_source(srcs: dict, subs) -> dict:
    """Apply each substitution to the one file of `srcs` ({file name: text})
    that holds its anchor."""
    srcs = dict(srcs)
    for a, b in subs:
        hits = [name for name, text in srcs.items() if a in text]
        if not hits:
            raise SystemExit(f"a variant's anchor is not in the sources: {a[:60]!r}")
        srcs[hits[0]] = srcs[hits[0]].replace(a, b)
    return srcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="all")
    ap.add_argument("--counts", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tiered_probe: no CUDA card is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops.kernels import _mask_hi, split_bf16, tiered_candidates

    names = {"all": list(VARIANTS), "none": []}.get(args.variants, args.variants.split(","))
    # the kernel and the shared selection header, which holds its merges
    src = {f: (_build.CSRC_DIR / f).read_text()
           for f in ("tiered_candidates.cu", "topk_select.cuh")}
    sources = {name: _variant_source(src, VARIANTS[name]) for name in names}
    if args.counts:
        sources["counts"] = _variant_source(src, COUNTS)
        sources["counts"]["tiered_candidates.cu"] += READ_COUNTS
    tmp = tempfile.mkdtemp(prefix="tiered_probe_")
    procs = {}
    for name, texts in sources.items():  # start every build before the inputs are made
        vdir = os.path.join(tmp, name)  # the variant's header shadows csrc/'s
        os.makedirs(vdir)
        for fname, text in texts.items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        path = os.path.join(vdir, "tiered_candidates.cu")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
               "-o", os.path.join(tmp, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)

    dev = torch.device("cuda", 0)
    N, D, B, kb = 1_000_000, 896, 512, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    mat = torch.rand((D, N), generator=gen, device=dev)
    mat.mul_(torch.rand((D, N), generator=gen, device=dev) < 0.05)
    hi, lo = split_bf16(mat)
    del mat
    live = torch.rand(N, generator=gen, device=dev) > 0.05
    rng = np.random.default_rng(0)
    q = np.zeros((B, D), np.float32)
    for r in range(B):
        q[r, rng.choice(D, int(rng.integers(1, 5)), replace=False)] = rng.uniform(0.5, 8, 1)
    q = torch.from_numpy(q).to(dev)
    qh = _mask_hi(q).to(torch.bfloat16)

    def msearch_shape():
        return tiered_candidates(q, hi, lo, live, kb)

    print(f"kernel, msearch shape: {cs.time_ms(msearch_shape, 5, dev):.4f} ms", flush=True)
    zq = torch.zeros_like(q)
    print(f"kernel, zero query rows (every lane -inf, nothing merged after the first "
          f"tile): {cs.time_ms(lambda: tiered_candidates(zq, hi, lo, live, kb), 5, dev):.4f} ms")
    print(f"bf16 cuBLAS qh @ hi (one of the two products): "
          f"{cs.time_ms(lambda: qh @ hi, 5, dev):.4f} ms", flush=True)
    del qh, zq
    # C4's exact arm: B=1024, D=384, cosine over standard normal vectors
    Dc, Bc = 384, 1024
    vt = torch.randn((Dc, N), generator=gen, device=dev)
    hc, lc = split_bf16(vt)
    aux_doc = 1.0 / torch.sqrt((vt * vt).sum(0))
    del vt
    qc = torch.randn((Bc, Dc), generator=gen, device=dev)
    aux_q = 1.0 / torch.sqrt((qc * qc).sum(1))
    allive = torch.ones(N, dtype=torch.bool, device=dev)
    kw = {"transform": "cosine", "aux_doc": aux_doc, "aux_q": aux_q, "count_positive": False}

    def c4_shape():
        return tiered_candidates(qc, hc, lc, allive, kb, **kw)

    print(f"kernel, C4 exact-arm shape: {cs.time_ms(c4_shape, 5, dev):.4f} ms", flush=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(f"variant {name}: build failed\n{out[-3000:]}")
            return 1
        lib = _build._libs["tiered_candidates"] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        if name != "counts":
            print(f"variant {name}, msearch shape: {cs.time_ms(msearch_shape, 5, dev):.4f} ms, "
                  f"C4 exact-arm shape: {cs.time_ms(c4_shape, 5, dev):.4f} ms", flush=True)
            continue
        for label, fn in (("msearch shape", msearch_shape), ("C4 exact-arm shape", c4_shape)):
            lib.probe_reset_counts()
            _, _, totals = fn()
            counts = (ctypes.c_ulonglong * 4)()
            lib.probe_read_counts(counts)
            print(f"counts, {label}, one launch: {counts[0]} merges, {counts[1]} by ranks, "
                  f"{counts[2]} by sort, {counts[3]} lanes above a threshold; "
                  f"{float(totals.float().mean()):.1f} counted lanes per row", flush=True)
    _build._libs.pop("tiered_candidates", None)  # the package's own build again
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
