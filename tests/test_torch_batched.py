"""The port's batched `_msearch` arms against the JAX package's.

Both packs are built from the same ~3,000 seeded documents (a Zipf
vocabulary of 400 terms, a low dense_min_df so the dense tier is populated
and some queries are dense-only). The queries are bench.py's C1 traffic
(`sample_queries`) plus an empty query, a missing term and a boosted pair.

Plans are byte-equal. Arm rows are held to the JAX package's own batched
contract (tests/test_batched.py): totals equal, scores within 1e-5
relative, ids equal except where the two scores agree within 1e-5 (an
fp-tie). The two sides sum in different orders: XLA's dot and CPU matmul,
f32 prefix sums in the reference's fast arms against f64 in the port's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu.ops.batched import BatchTermSearcher as RefBatchTermSearcher
from elasticsearch_tpu.query.executor import ShardSearcher as RefShardSearcher
from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus, sample_queries
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.ops import kernels as port_kernels
from elasticsearch_tpu_torch.ops.batched import fetch
from elasticsearch_tpu_torch.query.executor import ShardSearcher

N_DOCS, VOCAB, DENSE_MIN_DF, K = 3000, 400, 100, 10
MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"}}}
PLAN_ARRAYS = ["W", "sparse_rows", "sparse_weights", "dense_rows", "dense_w", "impact_w"]


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


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=VOCAB)
    queries = sample_queries(rng, lens, tok, 48) + [
        [], [("zzz", 1.0)], [("t1", 2.0), ("t300", 0.5)]]
    rm = RefMappings(MAPPING)
    rb = RefPackBuilder(rm)
    rb.add_documents_batch([rm.parse_document(d) for d in docs])
    ref_pack = rb.build(dense_min_df=DENSE_MIN_DF)
    pm = Mappings(MAPPING)
    pb = PackBuilder(pm)
    pb.add_documents_batch([pm.parse_document(d) for d in docs])
    port_pack = pb.build(dense_min_df=DENSE_MIN_DF)
    ref = RefBatchTermSearcher(RefShardSearcher(ref_pack, mappings=rm))
    port = ShardSearcher(port_pack, device="cpu", mappings=pm)
    return ref, port, queries


def _assert_rows(got, want, what):
    """totals equal; finite lanes alike; scores within 1e-5 relative; ids
    equal up to fp-ties within 1e-5."""
    gv, gi, gt = (np.asarray(x) for x in got[:3])
    wv, wi, wt = (np.asarray(x) for x in want[:3])
    np.testing.assert_array_equal(gt, wt, err_msg=what)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite, err_msg=what)
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=1e-5, atol=0, err_msg=what)
    swapped = finite & (gi != wi)
    gap = np.abs(gv[swapped] - wv[swapped])
    assert (gap <= 1e-5 * np.maximum(np.abs(wv[swapped]), 1.0)).all(), what


def test_plans_byte_equal(setup):
    ref, port, queries = setup
    bs = port.batched()
    pairs = [(bs.plan("body", queries, K), ref.plan("body", queries, K))]
    got_b, want_b = bs.plan_bucketed("body", queries, K), ref.plan_bucketed("body", queries, K)
    assert len(got_b) == len(want_b) >= 3
    for (gi, gp), (wi, wp) in zip(got_b, want_b):
        np.testing.assert_array_equal(gi, wi)
        pairs.append((gp, wp))
    assert any(p.dense_only for p, _ in pairs) and any(p.impact_w is not None for p, _ in pairs)
    for gp, wp in pairs:
        assert (gp.k, gp.dense_only) == (wp.k, wp.dense_only)
        for name in PLAN_ARRAYS:
            a, b = getattr(gp, name), getattr(wp, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, name
                assert a.tobytes() == b.tobytes(), name


def _ref_rows(out):
    """A reference arm's output (chunks or arrays) as numpy arrays."""
    return [np.asarray(x) for x in (out.resolve() if hasattr(out, "resolve") else out)]


@pytest.mark.parametrize("arm", ["exact", "fast", "impact", "tiered"])
def test_arm_rows_match_reference(setup, arm):
    """Each arm, group by group, against the same arm of the reference."""
    ref, port, queries = setup
    bs = port.batched()
    ran = 0
    for (_, plan), (_, ref_plan) in zip(bs.plan_bucketed("body", queries, K),
                                        ref.plan_bucketed("body", queries, K)):
        if (arm == "tiered") != plan.dense_only:
            continue
        if arm == "exact":
            got, want = bs.run("body", plan), ref.run("body", ref_plan)
        elif arm == "impact":
            got, want = bs.run_impact("body", plan), ref.run_impact("body", ref_plan)
        else:
            got, want = bs.run_fast("body", plan), ref.run_fast("body", ref_plan)
        got, want = fetch([got])[0], _ref_rows(want)
        _assert_rows(got, want, f"{arm} {plan.sparse_rows.shape}")
        if arm != "exact":
            assert len(got) == 5
            np.testing.assert_array_equal(got[4], want[4])  # dropped counts
        ran += 1
    assert ran >= (1 if arm == "tiered" else 3)


def test_fast_arm_forced_cut_flags_and_bracket(setup):
    """A tiny candidate budget (M=8) must either prove exactness or flag,
    and [lb, lb + dropped] must bracket the exact total (the reference's
    tests/test_batched.py contract); dropped counts equal the reference's."""
    ref, port, queries = setup
    bs = port.batched()
    checked = 0
    for (_, plan), (_, ref_plan) in zip(bs.plan_bucketed("body", queries, K),
                                        ref.plan_bucketed("body", queries, K)):
        if plan.dense_only:
            continue
        for run, ref_run in ((bs.run_fast, ref.run_fast), (bs.run_impact, ref.run_impact)):
            fv, fi, lb, exact, dropped = fetch([run("body", plan, M=8)])[0]
            ev, ei, et = fetch([bs.run("body", plan)])[0]
            assert ((lb <= et) & (et <= lb + dropped)).all()
            if run == bs.run_fast:
                np.testing.assert_allclose(fv[exact], ev[exact], rtol=1e-5)
            np.testing.assert_array_equal(dropped, _ref_rows(ref_run("body", ref_plan, M=8))[4])
            checked += int((dropped > 0).sum())
    assert checked > 0  # the cut really dropped candidates


@pytest.mark.parametrize("variant", ["impact", "fast", "exact"])
def test_msearch_matches_reference(setup, monkeypatch, variant):
    """msearch end to end: the impact arm (the reference's ES_TPU_IMPACT=
    force), the fast arm (a pack without the impact tier here, =0 there)
    and fast=False, with the escalation loop and the totals contract."""
    ref, port, queries = setup
    monkeypatch.setenv("ES_TPU_IMPACT", "force" if variant == "impact" else "0")
    searcher = port
    if variant == "fast":
        bare = dataclasses.replace(port.pack, impact_codes=None, impact_ubf=None,
                                   impact_meta=None)
        searcher = ShardSearcher(bare, device="cpu", mappings=port.mappings)
    fast = variant != "exact"
    got = searcher.msearch("body", queries, K, fast=fast)
    want = ref.msearch("body", queries, K, fast=fast)
    _assert_rows(got, want, variant)
    assert got[0].shape == (len(queries), K) and got[1].dtype == np.int64
    assert got[2][-3] == 0 and got[2][-2] == 0  # the empty query, the missing term
    arms = searcher.batched().last_stats["queries"]
    want_arms = {"impact": {"impact", "tiered"}, "fast": {"fast", "tiered"},
                 "exact": {"exact"}}[variant]
    assert set(arms) == want_arms


@pytest.mark.parametrize("k", [70, 150], ids=["dense_arm", "beyond_kernel_k"])
def test_msearch_large_k_matches_reference(setup, monkeypatch, k):
    """k above KB_TIERED sends dense-only groups to the dense scan; k above
    the kernels' 128 selects by a stable sort (the reference's top_k)."""
    ref, port, queries = setup
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    got = port.msearch("body", queries, k)
    assert set(port.batched().last_stats["queries"]) == {"impact", "dense"}
    _assert_rows(got, ref.msearch("body", queries, k), f"k={k}")


def test_msearch_escalates_flagged_queries(setup, monkeypatch):
    """With the candidate budget shrunk, first-pass flags escalate and the
    rows still equal those of the uncut run of the same arms."""
    ref, port, queries = setup
    bs = port.batched()
    want = bs.msearch("body", queries, K)
    assert bs.last_stats["rounds"] == 0 and want[3].all()
    monkeypatch.setattr(bs, "FAST_M", 8)
    got = bs.msearch("body", queries, K)
    assert bs.last_stats["rounds"] >= 1 and not got[3].all()
    _assert_rows(got, want, "escalated")


@pytest.mark.parametrize("k", [K, 25])
def test_msearch_bf16_matches_reference(setup, monkeypatch, k):
    """msearch(bf16=True) on the fast arm (the impact arm repriced out here,
    ES_TPU_IMPACT=0 there): the dense product on bf16 operands with f32
    sums, held to the reference's bf16 rows by the batched contract. It is
    another score function than f32's, and the impact arm ignores bf16."""
    from elasticsearch_tpu_torch.planner import execution_planner

    ref, port, queries = setup
    bs = port.batched()
    monkeypatch.setenv("ES_TPU_IMPACT", "0")
    with execution_planner().reprice(["impact"]):
        got = port.msearch("body", queries, k, bf16=True)
        assert set(bs.last_stats["queries"]) == {"fast", "tiered"}
        f32 = port.msearch("body", queries, k)
    want = ref.msearch("body", queries, k, bf16=True)
    _assert_rows(got, want, f"bf16 k={k}")
    fin = np.isfinite(f32[0])
    assert not np.array_equal(got[0][fin], f32[0][fin])
    np.testing.assert_allclose(got[0][fin], f32[0][fin], rtol=2e-2)
    with execution_planner().reprice(["exact"]):  # the planner is warm by now
        imp = port.msearch("body", queries, k, bf16=True)
        assert "impact" in bs.last_stats["queries"]
        for a, b in zip(imp, port.msearch("body", queries, k)):
            np.testing.assert_array_equal(a, b)


def test_msearch_bf16_proof_holds_when_the_cut_is_forced(setup, monkeypatch):
    """bf16 with small candidate budgets (M=8, 32, 128): a query the proof passes has
    the uncut bf16 run's rows byte for byte, the totals bracket holds, the
    proof's bound W @ rowmax_bf16 · (1 + 2^-7) dominates every bf16 dense
    score, and msearch's escalation returns the uncut rows."""
    from elasticsearch_tpu_torch.index.pack import BLOCK
    from elasticsearch_tpu_torch.ops.batched import bf16_product

    _, port, queries = setup
    bs = port.batched()
    extras = bs._fast_extras(True)
    dense = port.dev["dense_tfn"]
    checked = proven = 0
    for _, plan in bs.plan_bucketed("body", queries, K):
        if plan.dense_only:
            continue
        C = plan.sparse_rows.shape[1] * plan.sparse_rows.shape[2] * BLOCK
        uv, ui, ut, uok, udrop = fetch([bs.run_fast("body", plan, M=C, bf16=True)])[0]
        assert uok.all() and (udrop == 0).all()
        for M in (8, 32, 128):
            fv, fi, lb, ok, dropped = fetch([bs.run_fast("body", plan, M=M, bf16=True)])[0]
            assert ((lb <= ut) & (ut <= lb + dropped)).all()
            np.testing.assert_array_equal(fv[ok], uv[ok])
            np.testing.assert_array_equal(fi[ok], ui[ok])
            checked += int((dropped > 0).sum())
            proven += int((ok & (dropped > 0)).sum())
        W = torch.from_numpy(plan.W)
        scores = bf16_product(W, extras["dense_bf16"]).masked_fill(~port.dev["live"], 0)
        ub = torch.matmul(W, extras["rowmax_bf16"]) * (1.0 + 2.0**-7)
        assert (scores.max(dim=1).values <= ub).all()
        assert bf16_product(W, extras["dense_bf16"]).dtype == torch.float32
        assert extras["dense_bf16"].dtype == torch.bfloat16 and dense.dtype == torch.float32
    assert checked > 0 and proven > 0  # the cut dropped candidates, and proofs passed
    want = bs.msearch("body", queries, K, bf16=True)
    monkeypatch.setattr(bs, "FAST_M", 8)
    got = bs.msearch("body", queries, K, bf16=True)
    assert bs.last_stats["rounds"] >= 1 and not got[3].all()
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)


def test_rank_topk_matches_reference():
    from elasticsearch_tpu.ops.fused import rank_topk as ref_rank_topk
    from elasticsearch_tpu_torch.ops.fused import rank_topk

    rng = np.random.default_rng(2)
    v = np.round(rng.random((4, 50)), 1).astype(np.float32)  # many ties
    v[:, ::7] = -np.inf
    ids = np.stack([rng.permutation(1000)[:50] for _ in range(4)]).astype(np.int32)
    gv, gi = (x.numpy() for x in rank_topk(torch.from_numpy(v), torch.from_numpy(ids), 12))
    wv, wi = (np.asarray(x) for x in ref_rank_topk(jnp.asarray(v), jnp.asarray(ids), 12))
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)


def test_cpu_run_launches_no_kernel(setup):
    ref, port, queries = setup
    before = dict(port_kernels.launch_counts)
    port.msearch("body", queries[:8], K)
    assert port_kernels.launch_counts == before
