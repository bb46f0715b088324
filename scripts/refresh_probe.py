#!/usr/bin/env python3
"""Two choices of the refresh, timed on one card by the caller's clock.

    python3 scripts/refresh_probe.py [--gc-docs 1000000,100000,20000]
        [--pairs 10] [--tails 16,64,256,1024,4096] [--rounds 10]

1. Whether pausing Python's cyclic collector during a full refresh pays
   (the engine does not pause it). For each size in `--gc-docs`, an
   `EsIndex` of that many bench-corpus docs (`corpus.make_corpus`) on the
   card is refreshed in full `2 * --pairs` times, paused and not paused in
   turns (paused, not, not, paused, ...). Paused: the collector is disabled
   around `idx.refresh()` and the young objects collected once
   (`gc.collect(0)`) before the clock stops. Each refresh is timed around
   the call with the card synchronised, then 100 `_search`es after it the
   same way, so a collection the pause defers is paid in one of the
   windows (or in the next refresh's). The collector's own seconds and
   runs per generation are read in each window through `gc.callbacks`.
2. The device-build floors (`index/device_build.DEVICE_BUILD_MIN`,
   `ANALYZE_DEVICE_MIN`). On the first `--gc-docs` index, a tail segment of
   each size in `--tails` new docs is built and uploaded as an incremental
   refresh does (`EsIndex._segment`, which leaves the index's tiers as they
   are) `--rounds` times with the floors at 0 (every stage on the card), at
   their values, and out of reach (every stage on the host), the three in
   a rotating order.

Prints one JSON line per timed run, the medians of each side, and the
card's name and power limit as `nvidia-smi` gives them.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NEVER = 1 << 62


class GcClock:
    """The collector's seconds and runs per generation since `reset`."""

    def __init__(self):
        self.reset()
        gc.callbacks.append(self._cb)

    def reset(self):
        self.seconds, self.runs, self._t0 = 0.0, [0, 0, 0], None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.runs[info["generation"]] += 1
            self._t0 = None

    def read(self) -> dict:
        return {"gc_s": round(self.seconds, 4), "gc_runs": list(self.runs)}


def _timed(fn, clock: GcClock, sync) -> tuple[float, dict]:
    clock.reset()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0, clock.read()


def _paused(fn) -> None:
    gc.disable()
    try:
        fn()
    finally:
        gc.enable()
        gc.collect(0)


def _median(rows: list, key: str) -> float:
    return statistics.median(r[key] for r in rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gc-docs", default="1000000,100000,20000")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--tails", default="16,64,256,1024,4096")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("refresh_probe: no CUDA card is available", file=sys.stderr)
        return 2
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus, traffic
    from elasticsearch_tpu_torch.engine import Engine
    from elasticsearch_tpu_torch.index import device_build as db

    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    clock = GcClock()
    rng = np.random.default_rng(0)
    summary: dict = {"gc": {}, "floors": {}}
    for k, n in enumerate(int(x) for x in args.gc_docs.split(",")):
        lens, tok, nums = make_corpus(rng, n)
        eng = Engine(device=device)
        idx = eng.create_index(f"probe{k}", MAPPINGS)
        for i, d in enumerate(corpus_docs(lens, tok, nums)):
            idx.index_doc(str(i), d)
        idx.refresh()  # the first build, outside the pairs
        queries = traffic(rng, lens, tok, 60, 20, 20)
        for q in queries[:5]:
            idx.search(q)
        rows = {"paused": [], "not paused": []}
        for r in range(2 * args.pairs):
            side = "paused" if r % 4 in (0, 3) else "not paused"
            idx._pending.update(idx._docs)  # every doc again: a full rebuild
            idx._dirty = True
            wall, during = _timed(idx.refresh if side == "not paused" else
                                  lambda: _paused(idx.refresh), clock, sync)
            after_wall, after = _timed(lambda: [idx.search(q) for q in queries], clock, sync)
            p = eng.refresh_recorder.profiles(1)["profiles"][0]
            row = {"docs": n, "gc": side, "kind": p["kind"], "refresh_s": round(wall, 4),
                   "profile_wall_s": round(p["wall_ms"] / 1e3, 4), **during,
                   "searches_after_s": round(after_wall, 4), "gc_after": after}
            rows[side].append(row)
            print(json.dumps(row), flush=True)
        summary["gc"][n] = {s: {"refresh_s": _median(v, "refresh_s"),
                                "searches_after_s": _median(v, "searches_after_s"),
                                "gc_s": _median(v, "gc_s")} for s, v in rows.items()}
        if k == 0:
            summary["floors"] = _floors(idx, db, clock, sync, rng, args)
        del idx, eng
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


def _floors(idx, db, clock, sync, rng, args) -> dict:
    """Tail segments built and uploaded with the floors at 0, at their
    values and out of reach. -> {tail docs: {side: median s}}."""
    from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus

    floors = {"zero": (0, 0), "floors": (db.DEVICE_BUILD_MIN, db.ANALYZE_DEVICE_MIN),
              "host": (NEVER, NEVER)}
    sides = list(floors)
    tails = [int(x) for x in args.tails.split(",")]
    lens, tok, nums = make_corpus(rng, max(tails))
    new = [(f"tail{i}", (d, idx.mappings.parse_document(d)))
           for i, d in enumerate(corpus_docs(lens, tok, nums))]
    extra = idx._base_nbytes + sum(t.nbytes for t in idx._tails)
    out = {}
    try:
        for t in tails:
            rows = {s: [] for s in sides}
            for r in range(args.rounds + 1):  # round 0 warms each side up
                for s in sides[r % 3:] + sides[:r % 3]:
                    db.DEVICE_BUILD_MIN, db.ANALYZE_DEVICE_MIN = floors[s]
                    wall, during = _timed(lambda: idx._segment(new[:t], extra, idx._tails),
                                          clock, sync)
                    if r:
                        row = {"tail_docs": t, "floors": s, "segment_s": round(wall, 5),
                               **during}
                        rows[s].append(row)
                        print(json.dumps(row), flush=True)
            out[t] = {s: _median(v, "segment_s") for s, v in rows.items()}
    finally:
        db.DEVICE_BUILD_MIN, db.ANALYZE_DEVICE_MIN = floors["floors"]
    return out


if __name__ == "__main__":
    sys.exit(main())
