#!/usr/bin/env python3
"""Attribute the time of `scan_topk`'s matmul route on one card.

    python3 scripts/scan_probe.py [--variants all|none|name,name,...] [--twin] [--counts]

Times the kernel (CUDA events, `chip_smoke.time_ms`) at the dense-scan shape
(B=64, D=384, N=1M, k=10, identity) and at the exact kNN arm's rerun (B=700
flagged rows of a 1,024 batch, D=384, N=1M, k=10, cosine), beside one
PyTorch call for the same function (`torch.topk` of the transformed
`q @ mat_t`, TF32 off). With --twin it also holds each result to the
PyTorch twin (`scan_topk_reference`: values, finite ids and totals equal)
and times the twin once. Then it builds variants of csrc/scan_topk.cu, each
with one part of the matmul kernel disabled by a text substitution, one
nvcc each, all started together, and times each at both shapes (k = 10). A
disabled part gives wrong results: the variants measure where the time
goes, nothing else. With --counts, one more build counts, in device
atomics, the selection's merges (warp_fold calls) at both shapes. Prints
ptxas's report for the kernel and each variant, one line per timing, and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PRODUCT = "    if (active) {\n      const float* qs"
SELECT = "      for (int i = 0; i < nrows; ++i) {\n        const int row = w0 + i;"
FOLD = "if (__any_sync(0xffffffffu, np > 0))"
MAT_LOADS = "for (int i = 0; i < (BK * BN / 4) / MATH_THREADS; ++i) {"
DEPTH = "#pragma unroll 8\n      for (int dd = 0; dd < BK; ++dd) {"
VARIANTS = {
    # the fma loop skipped: loads, the ring and the selection of zeros
    "no_product": [(PRODUCT, PRODUCT.replace("if (active)", "if (N < 0)"))],
    # the per-tile selection skipped: loads and the product only
    "no_select": [(SELECT, SELECT.replace("i < nrows;", "i < nrows && N < 0;"))],
    # the selection without the merges of the lanes that beat a threshold
    "no_fold": [(FOLD, "if (N < 0 && __any_sync(0xffffffffu, np > 0))")],
    # the product alone: no mat_t loads, no selection
    "product_only": [(SELECT, SELECT.replace("i < nrows;", "i < nrows && N < 0;")),
                     (MAT_LOADS, "for (int i = 0; i < 0; ++i) {")],
    # the depth loop unrolled fully (BK times), not 8 times
    "unroll_full": [(DEPTH, DEPTH.replace("#pragma unroll 8", "#pragma unroll"))],
}
COUNTS = [  # device counters: merges, merges by ranks, merges by sort, lanes merged
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
SHAPES = {"B64_identity": (64, "identity"), "B700_cosine": (700, "cosine")}


def _matmul_resources(log: str) -> str:
    """ptxas's registers, stack and spill lines for scan_matmul_kernel."""
    lines = log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln and "scan_matmul_kernel" in ln:
            return " ".join(x.split("info    :")[-1].strip() for x in lines[j + 2: j + 4])
    return "not found"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="all")
    ap.add_argument("--twin", action="store_true")
    ap.add_argument("--counts", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("scan_probe: no CUDA card is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import _build
    from elasticsearch_tpu_torch.ops.kernels import (_apply_transform, scan_topk,
                                                     scan_topk_reference)

    names = {"all": list(VARIANTS), "none": []}.get(args.variants, args.variants.split(","))
    # the kernel and the shared selection header, which holds its merges
    src = {f: (_build.CSRC_DIR / f).read_text() for f in ("scan_topk.cu", "topk_select.cuh")}
    tmp = tempfile.mkdtemp(prefix="scan_probe_")
    procs = {}
    subs = {name: VARIANTS[name] for name in names}
    if args.counts:
        subs["counts"] = COUNTS
    for name, pairs in subs.items():  # start every build before the inputs are made
        texts = dict(src)
        if name == "counts":
            texts["scan_topk.cu"] += READ_COUNTS
        for a, b in pairs:
            hits = [f for f, text in texts.items() if a in text]
            if not hits:
                raise SystemExit(f"a variant's anchor is not in the sources: {a[:60]!r}")
            texts[hits[0]] = texts[hits[0]].replace(a, b)
        vdir = os.path.join(tmp, name)  # the variant's header shadows csrc/'s
        os.makedirs(vdir)
        for fname, text in texts.items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
               "-o", os.path.join(tmp, f"{name}.so"), os.path.join(vdir, "scan_topk.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    _build.load("scan_topk")
    print(f"ptxas, scan_matmul_kernel: {_matmul_resources(_build.build_log('scan_topk'))}")

    dev = torch.device("cuda", 0)
    N, D = 1_000_000, 384
    gen = torch.Generator(device=dev).manual_seed(3)
    mat = torch.randn((D, N), generator=gen, device=dev)
    live = torch.rand(N, generator=gen, device=dev) > 0.05
    sq = (mat * mat).sum(0)
    inputs = {}
    for label, (B, transform) in SHAPES.items():
        q = torch.randn((B, D), generator=gen, device=dev)
        aux_doc = 1.0 / torch.sqrt(sq) if transform == "cosine" else None
        aux_q = 1.0 / torch.sqrt((q * q).sum(1)) if transform == "cosine" else None
        inputs[label] = (q, transform, aux_doc, aux_q)

    def run(label):
        q, transform, aux_doc, aux_q = inputs[label]
        return scan_topk(q, mat, live, 10, transform=transform, aux_doc=aux_doc,
                         aux_q=aux_q, count_positive=False)

    def library(label):
        q, transform, aux_doc, aux_q = inputs[label]
        zq = torch.zeros((q.shape[0], 1), device=dev)
        s = _apply_transform(q @ mat, transform, aux_doc if aux_doc is not None else 0.0,
                             aux_q[:, None] if aux_q is not None else zq)
        return torch.topk(torch.where(live, s, float("-inf")), 10, dim=1)

    print(f"read bandwidth: torch.sum(mat_t, 0) {cs.time_ms(lambda: mat.sum(0), 5, dev):.4f} ms "
          f"for {mat.numel() * 4 / 1e9:.2f} GB")
    for label, (B, _t) in SHAPES.items():
        print(f"kernel {label}: {cs.time_ms(lambda: run(label), 5, dev):.4f} ms; library "
              f"{cs.time_ms(lambda: library(label), 5, dev):.4f} ms; bound "
              f"{2 * B * D * N / 67e12 * 1e3:.4f} ms (operations)", flush=True)
        if args.twin:
            q, transform, aux_doc, aux_q = inputs[label]
            got = run(label)
            zn, zb = torch.zeros(N, device=dev), torch.zeros(B, device=dev)
            box = []
            t = cs.time_ms(lambda: box.append(scan_topk_reference(
                q, mat, live, 10, transform=transform,
                aux_doc=aux_doc if aux_doc is not None else zn,
                aux_q=aux_q if aux_q is not None else zb, count_positive=False)),
                1, dev, warm=False)
            cs.compare(got, box[0], f"matmul {label}")
            print(f"twin {label}: equal; {t:.1f} ms", flush=True)
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(f"variant {name}: build failed\n{out[-3000:]}")
            return 1
        lib = _build._libs["scan_topk"] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        if name == "counts":
            for label in SHAPES:
                lib.probe_reset_counts()
                run(label)
                counts = (ctypes.c_ulonglong * 4)()
                lib.probe_read_counts(counts)
                print(f"counts, {label}, one launch: {counts[0]} merges, {counts[1]} by ranks, "
                      f"{counts[2]} by sort, {counts[3]} lanes merged", flush=True)
            continue
        print(f"variant {name} ({_matmul_resources(out)}): " + "; ".join(
            f"{label} {cs.time_ms(lambda: run(label), 5, dev):.4f} ms" for label in SHAPES),
            flush=True)
    _build._libs.pop("scan_topk", None)  # the package's own build again
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
