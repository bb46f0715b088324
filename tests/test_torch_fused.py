"""The port's fused `_msearch` arm against the JAX package's.

Both packs are built from the same ~9,000 seeded documents (a Zipf
vocabulary of 400 terms, dense_min_df 64): three 4,096-doc tiles with a
partial tail, and terms in both the dense tier and the CSR tail. The JAX
package's fused arm runs on the CPU only when forced, so this module sets
`ES_TPU_FUSED=force` and `ES_TPU_FUSED_TILE=4096` (the port's tile, so
both sides keep the same per-tile t); its kernel runs in interpret mode.

Tolerances:
  - plans are byte-equal on the port's rows;
  - the kernel twin's per-tile candidates against the Pallas kernel's:
    counts and finite lanes equal, values within 1e-4 relative (the Pallas
    kernel adds the sparse tail in split bf16 through one-hot MXU products,
    the port in exact f32; both dense halves are split-bf16 sums in other
    orders; an order statistic moves by at most the elementwise error);
  - `canonical_rescore` within 1e-6 relative (sums in other orders);
  - final rows against the JAX package's fused rows and the port's exact
    arm: totals equal, scores within 1e-6 relative, ids equal up to
    fp-ties (scores within 1e-5 relative).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu.ops import fused as ref_fused
from elasticsearch_tpu.ops.batched import BatchTermSearcher as RefBatchTermSearcher
from elasticsearch_tpu.query.executor import ShardSearcher as RefShardSearcher
from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus, sample_queries
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.ops import fused
from elasticsearch_tpu_torch.ops import kernels as port_kernels
from elasticsearch_tpu_torch.query.executor import ShardSearcher

REPO = Path(__file__).resolve().parent.parent
N_DOCS, VOCAB, DENSE_MIN_DF, K = 9000, 400, 64, 10
MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"}}}
RARE = f"t{VOCAB - 1}"  # a CSR-tail term


@pytest.fixture(autouse=True)
def _cold_planners():
    """Both packages' execution planners start each test cold: a planner
    warmed by an earlier test could route a batch to another arm."""
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


@pytest.fixture(scope="module", autouse=True)
def _force_reference_fused():
    mp = pytest.MonkeyPatch()
    mp.setenv("ES_TPU_FUSED", "force")
    mp.setenv("ES_TPU_FUSED_TILE", str(fused.TILE_N))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def setup(_force_reference_fused):
    rng = np.random.default_rng(31)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=VOCAB)
    queries = sample_queries(rng, lens, tok, 40) + [
        [], [("zzz", 1.0)], [("t1", 2.0), (RARE, 0.5)], [(RARE, 1.0), ("t350", 1.0)],
        [("t3", 1.0), ("t3", 0.5), ("t300", 1.0)], [(RARE, 1.0), (RARE, 2.0), ("t9", 1.0)]]
    rm = RefMappings(MAPPING)
    rb = RefPackBuilder(rm)
    rb.add_documents_batch([rm.parse_document(d) for d in docs])
    ref_pack = rb.build(dense_min_df=DENSE_MIN_DF)
    pm = Mappings(MAPPING)
    pb = PackBuilder(pm)
    pb.add_documents_batch([pm.parse_document(d) for d in docs])
    port_pack = pb.build(dense_min_df=DENSE_MIN_DF)
    ref_fs = ref_fused.FusedTermSearcher(
        RefBatchTermSearcher(RefShardSearcher(ref_pack, mappings=rm)))
    port = ShardSearcher(port_pack, device="cpu", mappings=pm)
    assert port_pack.dense_dict and port_pack.num_docs % fused.TILE_N
    return ref_fs, port, queries


def _assert_rows(got, want, what, rtol=1e-6):
    """totals equal; finite lanes alike; scores within rtol; ids equal up to
    fp-ties within 1e-5."""
    gv, gi, gt = (np.asarray(x) for x in got[:3])
    wv, wi, wt = (np.asarray(x) for x in want[:3])
    np.testing.assert_array_equal(gt, wt, err_msg=what)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite, err_msg=what)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=rtol, atol=0, err_msg=what)
    swapped = finite & (gi != wi)
    gap = np.abs(gv[swapped] - wv[swapped])
    assert (gap <= 1e-5 * np.maximum(np.abs(wv[swapped]), 1.0)).all(), what


def _exact(searcher, queries, k=K):
    bs = searcher.batched()
    return bs.search("body", queries, k)


def test_plan_fused_byte_equal(setup):
    ref_fs, port, queries = setup
    nq = len(queries)
    got = fused.plan_fused(port.pack, "body", queries, K, qc=nq)
    want = ref_fused.plan_fused(ref_fs.searcher.pack, "body", queries, K)
    assert want.dense_rows.shape[0] == ref_fused.QC and got.dense_rows.shape[0] == nq
    for name in ("rows", "row_q", "row_w"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("dense_rows", "dense_w"):
        a, b = getattr(got, name), getattr(want, name)[:nq]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    nreal = int((got.rows != 0).sum())  # row 0 is the all-padding block
    assert got.k == want.k and nreal == want.nreal > 0
    # term ordinals: 0.. within each query's rows, and 0 on padding rows
    assert got.ts == max(got.row_t[:nreal]) + 1 and not got.row_t[nreal:].any()
    assert got.rows.shape[0] >= 64 and got.rows.shape[0] & (got.rows.shape[0] - 1) == 0


def _record(monkeypatch, module):
    """Wrap module.fused_tile_candidates so its outputs are kept."""
    seen = []
    inner = module.fused_tile_candidates

    def spy(*a, **kw):
        out = inner(*a, **kw)
        seen.append([np.asarray(x) for x in out])
        return out

    monkeypatch.setattr(module, "fused_tile_candidates", spy)
    return seen


def test_tile_candidates_twin_matches_pallas_kernel(setup, monkeypatch):
    """One chunk of the same queries through both pipelines; each side
    builds its own window keys. Per tile: counts, finite lanes, values."""
    ref_fs, port, queries = setup
    pack = port.pack
    n = pack.num_docs
    njc = -(-n // fused.TILE_N)
    t = fused.tile_t_for(njc)
    assert t == ref_fused.tile_t_for(njc)
    nq = len(queries)

    want_seen = _record(monkeypatch, ref_fused)
    rp = ref_fused.plan_fused(ref_fs.searcher.pack, "body", queries, K)
    nreal_q = 1 << max(rp.nreal - 1, 1).bit_length()  # the JAX package's window budget
    mean_win = max(1, nreal_q * 128 // ((ref_fused.QC // ref_fs._qsub) * njc))
    bud = min(64 * 1024, max(2048, 1 << (2 * mean_win - 1).bit_length())) // 128
    ref_fused._fused_pipeline(
        ref_fs._arrays(), np.float32(pack.avgdl("body")), rp.rows, rp.row_q, rp.row_w,
        rp.dense_rows, rp.dense_w, k=K, n=n, n_pad=njc * fused.TILE_N, has_norms=True,
        k1=1.2, b=0.75, bud=bud, t=t, tile_n=fused.TILE_N, interpret=True,
        qsub=ref_fs._qsub, inkernel=ref_fs._inkernel)

    got_seen = _record(monkeypatch, fused)
    bs = port.batched()
    fs = bs._fused_searcher(K)
    fs._dispatch_batch("body", queries, K)
    (wv, wi, wt, wl), (gv, gi, gt, gl) = want_seen[0], got_seen[0]
    wv, wi, wt, wl = wv[:nq], wi[:nq], wt[:nq], wl[:nq]
    assert gv.shape == wv.shape == (nq, njc * t)
    np.testing.assert_array_equal(gt, wt)
    assert gt.sum() > 0 and not gl.any() and not wl.any()
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=1e-4, atol=0)
    assert (gi[finite] < n).all() and (gi[finite] // fused.TILE_N
                                       == np.nonzero(finite)[1] // t).all()
    # the per-tile counts bound the finite lanes: min(t, count) per tile
    assert finite.reshape(nq, njc, t).sum(2).max() <= t


def test_canonical_rescore_matches_reference(setup):
    ref_fs, port, queries = setup
    pack = port.pack
    nq = len(queries)
    p = fused.plan_fused(pack, "body", queries, K, qc=nq)
    docids = pack.post_docids[p.rows]
    tfs = pack.post_tfs[p.rows]
    dls = pack.post_dls[p.rows]
    avgdl = np.float32(pack.avgdl("body"))
    parts = (p.row_w[:, None] * tfs / (tfs + np.float32(1.2) * (
        np.float32(0.25) + np.float32(0.75) * dls / avgdl))).astype(np.float32)
    # winners: the exact arm's top KB, so the sparse parts are exercised
    ev, cand_i, _ = _exact(port, queries, fused.KB)
    cand_ok = np.isfinite(ev)
    cand_ok[:, ::5] = False
    cand_i = np.where(cand_ok, cand_i, 0).astype(np.int32)
    want = np.asarray(ref_fused.canonical_rescore(
        jnp.asarray(pack.dense_tfn), jnp.asarray(p.dense_rows), jnp.asarray(p.dense_w),
        jnp.asarray(p.row_q), jnp.asarray(docids), jnp.asarray(parts),
        jnp.asarray(cand_i), jnp.asarray(cand_ok)))
    got = fused.canonical_rescore(
        torch.from_numpy(pack.dense_tfn), torch.from_numpy(p.dense_rows),
        torch.from_numpy(p.dense_w), torch.from_numpy(p.row_q), torch.from_numpy(p.row_t),
        torch.from_numpy(docids), torch.from_numpy(parts), torch.from_numpy(cand_i),
        torch.from_numpy(cand_ok), p.ts).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert finite.sum() == cand_ok.sum() and (want[finite] > 0).mean() > 0.5
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=0)


def test_fused_msearch_matches_reference_and_exact_arm(setup):
    ref_fs, port, queries = setup
    got = port.msearch("body", queries, K)
    st = port.batched().last_stats
    assert st["queries"] == {"fused": len(queries)} and st["chunks"] == {"fused": 1}
    assert got[0].shape == (len(queries), K) and got[1].dtype == np.int64
    assert got[3].mean() > 0.9  # first pass proven for almost every query
    assert got[2][41] == 0 and not np.isfinite(got[0][41]).any()  # missing term
    _assert_rows(got, ref_fs.msearch("body", queries, K), "reference fused")
    _assert_rows(got, _exact(port, queries), "exact arm")


def _live_case(case):
    live = np.ones(N_DOCS, bool)
    if case == "deleted":
        live[100:2600] = False
    elif case.startswith("prefix_"):
        live[int(case.split("_")[1]):] = False
    elif case == "few_live":
        live[150:] = False
    return live


@pytest.mark.parametrize("case", ["deleted", "prefix_4095", "prefix_4097",
                                  "prefix_8229", "few_live", "absent_terms"])
def test_fused_edge_cases_match_exact_arm(setup, case):
    """Deleted docs, live prefixes across a tile edge, few live matches
    (k above the match count) and absent terms, against the exact arm."""
    _, port, queries = setup
    live = _live_case(case)
    s = ShardSearcher(dataclasses.replace(port.pack, live=live), device="cpu",
                      mappings=port.mappings)
    qs = queries[:16] + queries[-5:]
    if case == "absent_terms":
        qs = [[("zz_nope", 1.0)], [("zz_nope", 1.0), ("zz_also", 2.0)], [(RARE, 1.0)],
              [("zz_nope", 1.0), ("t2", 1.0)]]
    got = s.msearch("body", qs, K)
    assert s.batched().last_stats["queries"] == {"fused": len(qs)}
    _assert_rows(got, _exact(s, qs), case)
    ids = got[1][np.isfinite(got[0])]
    assert live[ids].all()
    if case == "few_live":
        assert (np.isfinite(got[0]).sum(1) < K).any()  # k above the match count
    if case == "absent_terms":
        assert (got[2][:2] == 0).all() and not np.isfinite(got[0][:2]).any()


def test_routing_by_k_and_pack_size(setup):
    """k <= 16 on a dense-tier pack of >= 4,096 docs takes only the fused
    arm; k = 25 (from=5, size=20) the impact and tiered arms; a pack under
    4,096 docs never the fused arm."""
    _, port, queries = setup
    bs = port.batched()
    port.msearch("body", queries, 16)
    assert set(bs.last_stats["queries"]) == {"fused"}
    port.msearch("body", queries, 25)
    assert set(bs.last_stats["queries"]) == {"impact", "tiered"}
    assert bs.choose_batch_arm(1, K) == "fused"  # the cold planner's static order
    assert bs.choose_batch_arm(1, K, fast=False) == "exact"
    assert bs.arm_of(bs.plan("body", queries[:1], K), fast=False) == "exact"
    rng = np.random.default_rng(4)
    lens, tok, nums = make_corpus(rng, 3000, vocab=VOCAB, mean_len=12)
    pm = Mappings(MAPPING)
    pb = PackBuilder(pm)
    pb.add_documents_batch([pm.parse_document(d) for d in corpus_docs(lens, tok, nums,
                                                                         vocab=VOCAB)])
    small = ShardSearcher(pb.build(dense_min_df=DENSE_MIN_DF), device="cpu", mappings=pm)
    assert small.pack.dense_tfn is not None
    small.msearch("body", queries, K)
    assert "fused" not in small.batched().last_stats["queries"]


def test_flagged_queries_escalate_to_exact_arm(setup, monkeypatch):
    """With 4 candidates per tile (the fewest whose 3 tiles still hold k)
    nearly every query saturates a tile and is flagged; the flagged queries
    re-run on the exact arm."""
    _, port, queries = setup
    monkeypatch.setattr(fused, "tile_t_for", lambda njc: 4)
    bs = port.batched()
    got = port.msearch("body", queries, K)
    st = bs.last_stats
    assert st["rounds"] == 1 and st["escalated"] == int((~got[3]).sum()) > len(queries) // 2
    _assert_rows(got, _exact(port, queries), "escalated")


def test_msearch_many_and_coalesced_rows_byte_identical(setup):
    _, port, queries = setup
    bs = port.batched()
    groups = [queries[:7], queries[7:30], queries[30:]]
    singles = [bs.msearch("body", g, K) for g in groups]
    assert all(s[3].all() for s in singles)
    for name, outs in (("many", bs.msearch_many("body", groups, K)),
                       ("coalesced", bs.msearch_coalesced("body", groups, K))):
        assert len(outs) == len(groups)
        for single, out in zip(singles, outs):
            for a, b in zip(single, out):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert bs.last_stats["queries"] == {"fused": len(queries)}
    assert bs.msearch_coalesced("body", [[], []], K)[1][0].shape == (0, K)


def test_cpu_run_launches_no_kernel(setup):
    _, port, queries = setup
    before = dict(port_kernels.launch_counts)
    port.msearch("body", queries[:8], K)
    assert port.batched().last_stats["queries"] == {"fused": 8}
    assert port_kernels.launch_counts == before


def test_fused_msearch_imports_no_jax():
    """A fused msearch through the port loads neither jax nor the JAX
    package."""
    code = (
        "import sys, json\n"
        "from elasticsearch_tpu_torch import EsIndex\n"
        "idx = EsIndex('x', {'properties': {'body': {'type': 'text'}}}, device='cpu')\n"
        "for i in range(4200):\n"
        "    idx.index_doc(str(i), {'body': 'hello world' if i % 3 else 'hello there'})\n"
        "idx.refresh()\n"
        "out = idx.msearch([{'query': {'match': {'body': 'hello there'}}},\n"
        "                   {'query': {'match': {'body': 'world'}}, 'size': 3}])\n"
        "arms = sorted(idx.searcher.batched().last_stats['queries'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'elasticsearch_tpu')\n"
        "print(json.dumps({'totals': [r['hits']['total']['value'] for r in out['responses']],"
        " 'arms': arms, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"totals": [4200, 2800], "arms": ["fused"], "bad": []}


@pytest.mark.parametrize("t", [1, 7, 65, 128, 129, 4096])
def test_kernel_route_by_t(t):
    """The wrapper picks the kernel's route from t before any launch: the
    warp selection up to 128 candidates per tile, the tile sort above; a
    route that does not take t is refused before the kernel is built."""
    assert fused.fused_route(t) == ("select" if t <= fused.SELECT_MAX_T else "sort")
    N = 5000
    hi = torch.zeros((2, N), dtype=torch.bfloat16)
    args = (hi, hi, torch.ones(N, dtype=torch.bool), torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, 4)), torch.zeros(0, dtype=torch.int32), torch.zeros(0),
            torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not take"):
        fused._fused_tile_candidates_cuda(*args, t, 13, route="bitonic")
    if t > fused.SELECT_MAX_T:
        with pytest.raises(ValueError, match="does not take"):
            fused._fused_tile_candidates_cuda(*args, t, 13, route="select")


def _brute_tiles(hi, lo, live, drows, dwh, keys, vals, ptr, t, db):
    """Per (row, tile) the t best lanes by (score desc, docid asc) and the
    positive count, lane by lane in numpy f32 with the kernel's operation
    order: the dense hi and lo sums over nonzero weights, added, then the
    sparse run sum."""
    hi = hi.view(torch.int16).numpy().astype(np.int32) << 16
    lo = lo.view(torch.int16).numpy().astype(np.int32) << 16
    hi, lo = hi.view(np.float32), lo.view(np.float32)
    Qc, Td = drows.shape
    N = hi.shape[1]
    njc = -(-N // fused.TILE_N)
    cv = np.full((Qc, njc, t), -np.inf, np.float32)
    ci = np.full((Qc, njc, t), -1, np.int64)
    tot = np.zeros(Qc, np.int64)
    for q in range(Qc):
        hs = np.zeros(N, np.float32)
        ls = np.zeros(N, np.float32)
        for i in range(Td):
            if dwh[q, i] != 0:
                hs = hs + dwh[q, i] * hi[drows[q, i]]
                ls = ls + dwh[q, i] * lo[drows[q, i]]
        sp = np.zeros(N, np.float32)
        for p in range(ptr[q, 0], ptr[q, -1]):
            if p == ptr[q, 0] or keys[p] != keys[p - 1]:  # a run's first entry sums it
                s, r = np.float32(0), p
                while r < ptr[q, -1] and keys[r] == keys[p]:
                    s, r = s + vals[r], r + 1
                sp[keys[p] & ((1 << db) - 1)] = s
        score = (hs + ls) + sp
        score = np.where(live & (score > 0), score, -np.inf).astype(np.float32)
        tot[q] = int((score > 0).sum())
        for j in range(njc):
            lanes = np.arange(j * fused.TILE_N, min(N, (j + 1) * fused.TILE_N))
            best = lanes[np.lexsort((lanes, -score[lanes]))][:t]
            cv[q, j, : len(best)], ci[q, j, : len(best)] = score[best], best
    return cv.reshape(Qc, -1), ci.reshape(Qc, -1), tot


@pytest.mark.parametrize("t", [1, 7, 65])
def test_twin_edge_rows_match_brute_force(t):
    """The twin the CUDA kernel is held to, against a lane-by-lane count of
    the contract on the selection's edge rows and tiles: rows without a
    dense weight, without a window, with neither; an all-dead tile, a tile
    with 2 live docs, the tail tile; duplicate entries; tied scores."""
    rng = np.random.default_rng(31)
    Qc, V, Td, N = 12, 6, 4, 2 * fused.TILE_N + 300
    tier = np.array([0.0, 0.25, 0.5], np.float32)[rng.integers(0, 3, (V, N))]
    hi, lo = port_kernels.split_bf16(torch.from_numpy(tier))
    live = rng.random(N) > 0.1
    live[fused.TILE_N: 2 * fused.TILE_N] = False
    live[2 * fused.TILE_N + np.array([3, 200])] = True
    live[:fused.TILE_N] &= rng.random(fused.TILE_N) > 0.5
    drows = np.sort(np.stack([rng.choice(V, Td, replace=False) for _ in range(Qc)]), 1)
    dwh = np.array([1.0, 2.0], np.float32)[rng.integers(0, 2, (Qc, Td))]
    dwh[rng.random((Qc, Td)) < 0.3] = 0
    dwh[:3] = dwh[6:9] = 0  # rows 0-2 sparse only
    njc = -(-N // fused.TILE_N)
    _, db, _ = fused._key_bits(njc * fused.TILE_N, 1, Qc)
    q = rng.integers(0, Qc, 3000)
    q = q[(q < 6) | (q >= 10)]  # rows 6-8 without either half, row 9 dense only
    doc = rng.integers(0, N, q.shape[0])
    dup = rng.random(q.shape[0]) < 0.3
    keys = np.sort(((np.concatenate([q, q[dup]]) << db)
                    | np.concatenate([doc, doc[dup]])).astype(np.int32))
    vals = np.array([0.5, 1.0], np.float32)[rng.integers(0, 2, keys.shape[0])]
    bounds = (np.arange(Qc)[:, None] << db) | (np.arange(njc + 1) * fused.TILE_N)[None, :]
    ptr = np.searchsorted(keys, bounds.reshape(-1)).astype(np.int32).reshape(Qc, njc + 1)
    got = fused.fused_tile_candidates(
        hi, lo, torch.from_numpy(live), torch.from_numpy(drows.astype(np.int32)),
        torch.from_numpy(dwh), torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(ptr), t=t, db=db)
    cv, ci, tot = _brute_tiles(hi, lo, live, drows, dwh, keys, vals, ptr, t, db)
    np.testing.assert_array_equal(got[0].numpy(), cv)
    np.testing.assert_array_equal(got[1].numpy(), ci)
    np.testing.assert_array_equal(got[2].numpy(), tot)
    assert (tot[6:9] == 0).all() and not np.isfinite(cv[6:9]).any()
