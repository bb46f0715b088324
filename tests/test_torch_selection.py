"""`check_tiered_selection`, the tolerance that holds the tensor-core
`tiered_candidates` kernel to its twin, and the contract of the arms that
consume its selection.

The kernel's products add in the tensor cores' order, so its selection
scores may differ from the twin's within 4·D·2^-24·Σ|qh|(|hi| + |lo|) per
lane (carried through the transform), and lanes within that bound of the
kb-th score may be kept the other way. Here, on the CPU:

- the check accepts the twin against itself and selections moved within
  the bound, and rejects each kind of violation;
- a stand-in for the kernel that returns the twin's selection with every
  score moved by a seeded fraction of its bound and the kb boundary resolved
  the other way among lanes within the bound leaves the final rows of the
  dense-only tiered arm (safe queries; `_msearch` as a whole) and of
  `TieredKnnScanner.search` (after its reruns) equal to the unperturbed
  run's and to the JAX package's. The margin tests of the arms
  (EPS_TIERED = 2e-2) are ~100x wider than the bound.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu.ops.batched import BatchTermSearcher as RefBatchTermSearcher
from elasticsearch_tpu.ops.vector import TieredKnnScanner as RefTieredKnnScanner
from elasticsearch_tpu.query.executor import ShardSearcher as RefShardSearcher
from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus, sample_queries
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.ops import batched as port_batched
from elasticsearch_tpu_torch.ops import kernels as port_kernels
from elasticsearch_tpu_torch.ops import vector as port_vector
from elasticsearch_tpu_torch.ops.batched import fetch
from elasticsearch_tpu_torch.ops.kernels import (
    check_tiered_selection,
    split_bf16,
    tiered_candidates_reference,
    tiered_lanes,
)
from elasticsearch_tpu_torch.ops.vector import TieredKnnScanner
from elasticsearch_tpu_torch.query.executor import ShardSearcher

# ---------------------------------------------------------------------------
# the check itself
# ---------------------------------------------------------------------------

B, D, N, KB = 4, 48, 2000, 16


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


def _inputs():
    """BM25-shaped inputs (non-negative weights and tier), with lane N-1 a
    copy of row 0's kb-th lane moved down by one f32 ulp in one entry: a
    lane within the bound of the kb-th score that the twin does not keep."""
    rng = np.random.default_rng(5)
    q = np.abs(rng.normal(size=(B, D))).astype(np.float32)
    mat = np.abs(rng.normal(size=(D, N))).astype(np.float32)
    live = torch.from_numpy(rng.random(N) > 0.1)
    live[-1] = True
    _, ids, _ = _twin(torch.from_numpy(q), *split_bf16(torch.from_numpy(mat)), live)
    y = int(ids[0, -1])
    mat[:, -1] = mat[:, y]
    d = int(np.argmax(mat[:, y]))
    mat[d, -1] = np.nextafter(mat[d, -1], np.float32(0))
    hi, lo = split_bf16(torch.from_numpy(mat))
    return torch.from_numpy(q), hi, lo, live


def _twin(q, hi, lo, live, kb=KB):
    return tiered_candidates_reference(q, hi, lo, live, kb, aux_doc=torch.zeros(hi.shape[1]),
                                       aux_q=torch.zeros(q.shape[0]), count_positive=True)


def _mutate(case, v, i, t, q, hi, lo, live):
    """The twin's output changed as `case` says -> (v, i, t)."""
    v, i, t = v.clone(), i.clone(), t.clone()
    _, bound = tiered_lanes(q, hi, lo, i, live=live, count_positive=True)
    if case == "shift_within_bound":
        # a row-wide shift keeps the order; 0.4 of the row's smallest bound
        v += (0.4 * bound.min(dim=1, keepdim=True).values).float()
    elif case in ("boundary_swap_within", "boundary_swap_beyond"):
        far = _twin(q, hi, lo, live, 3 * KB)[1][0, -1]
        x = torch.tensor(N - 1 if case == "boundary_swap_within" else int(far))
        i[0, -1] = x
        v[0, -1] = tiered_lanes(q, hi, lo, x.view(1, 1).expand(B, 1), live=live,
                                count_positive=True)[0][0, 0]
    elif case == "score_past_bound":
        v[0, 0] += float(3 * bound[0, 0])
    elif case == "totals":
        t[1] += 1
    elif case == "misordered":
        v[0, [0, 1]] = v[0, [1, 0]]
        i[0, [0, 1]] = i[0, [1, 0]]
    return v, i, t


CHECK_CASES = {"twin": None, "shift_within_bound": None, "boundary_swap_within": None,
               "boundary_swap_beyond": "swaps", "score_past_bound": "from the twin's",
               "totals": "totals differ", "misordered": "not ordered"}


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_check_tiered_selection(case):
    q, hi, lo, live = _inputs()
    want = _twin(q, hi, lo, live)
    assert int(want[1][0, -1]) != N - 1  # the copy ties or trails the kb-th lane
    got = _mutate(case, *want, q, hi, lo, live)
    if case == "misordered":
        assert got[0][0, 0] < got[0][0, 1]
    match = CHECK_CASES[case]
    if match is None:
        ratio, err = check_tiered_selection(got, want, q, hi, lo, live)
        assert 0.0 <= ratio <= 1.0
        assert (ratio > 0.0) == (case == "shift_within_bound") and (err > 0.0) == (ratio > 0.0)
    else:
        with pytest.raises(AssertionError, match=match):
            check_tiered_selection(got, want, q, hi, lo, live)


# ---------------------------------------------------------------------------
# the arms' contract under a selection that differs within the bound
# ---------------------------------------------------------------------------


class _Perturbed:
    """A stand-in for `tiered_candidates`: the twin's selection, the kb
    boundary resolved the other way wherever the (kb+1)-th lane lies within
    the bound of the kb-th, every finite score moved by a seeded fraction in
    (-1, 1) of its bound, rows re-sorted by (score desc, id asc). Each
    result is checked to pass `check_tiered_selection`."""

    def __init__(self, seed):
        self.gen = np.random.default_rng(seed)
        self.swaps = 0
        self.calls = 0

    def __call__(self, q, hi, lo, live, kb, *, transform="identity", aux_doc=None,
                 aux_q=None, count_positive=True):
        n = hi.shape[1]
        aux_doc = torch.zeros(n) if aux_doc is None else aux_doc
        aux_q = torch.zeros(q.shape[0]) if aux_q is None else aux_q
        kw = {"transform": transform, "aux_doc": aux_doc, "aux_q": aux_q,
              "count_positive": count_positive}
        want = tiered_candidates_reference(q, hi, lo, live, kb, **kw)
        lanes = {"transform": transform, "aux_doc": aux_doc, "aux_q": aux_q, "live": live,
                 "count_positive": count_positive}
        v, i, t = (x.clone() for x in want)
        if kb < n:
            v1, i1, _ = tiered_candidates_reference(q, hi, lo, live, kb + 1, **kw)
            _, b1 = tiered_lanes(q, hi, lo, i1, **lanes)
            near = (torch.isfinite(v1[:, kb])
                    & ((v1[:, kb - 1] - v1[:, kb]).double() <= b1[:, kb] + b1[:, kb - 1]))
            i[near, kb - 1] = i1[near, kb]
            v[near, kb - 1] = v1[near, kb]
            self.swaps += int(near.sum())
        _, bound = tiered_lanes(q, hi, lo, i, **lanes)
        frac = torch.from_numpy(self.gen.uniform(-0.9, 0.9, v.shape))
        fin = torch.isfinite(v)
        v = torch.where(fin, (v.double() + frac * bound).float(), v)
        by_id = torch.argsort(i, dim=1, stable=True)
        v, i = v.gather(1, by_id), i.gather(1, by_id)
        pos = torch.sort(v, dim=1, descending=True, stable=True).indices
        v, i = v.gather(1, pos), i.gather(1, pos)
        ratio, _ = check_tiered_selection((v, i, t), want, q, hi, lo, live, **kw)
        assert ratio <= 1.0
        self.calls += 1
        return v, i, t


N_DOCS, VOCAB, DENSE_MIN_DF, K = 3000, 400, 100, 10
MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"}}}


@pytest.fixture(scope="module")
def text_setup():
    rng = np.random.default_rng(11)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=VOCAB)
    queries = sample_queries(rng, lens, tok, 48)
    rm = RefMappings(MAPPING)
    rb = RefPackBuilder(rm)
    rb.add_documents_batch([rm.parse_document(d) for d in docs])
    pm = Mappings(MAPPING)
    pb = PackBuilder(pm)
    pb.add_documents_batch([pm.parse_document(d) for d in docs])
    ref = RefBatchTermSearcher(RefShardSearcher(rb.build(dense_min_df=DENSE_MIN_DF), mappings=rm))
    port = ShardSearcher(pb.build(dense_min_df=DENSE_MIN_DF), device="cpu", mappings=pm)
    return ref, port, queries


def _close(got, want, what):
    """The JAX package's batched contract: totals equal, scores within 1e-5
    relative, ids equal up to fp-ties within 1e-5."""
    gv, gi, gt = (np.asarray(x) for x in got[:3])
    wv, wi, wt = (np.asarray(x) for x in want[:3])
    np.testing.assert_array_equal(gt, wt, err_msg=what)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=what)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=0, err_msg=what)
    swapped = fin & (gi != wi)
    assert (np.abs(gv[swapped] - wv[swapped])
            <= 1e-5 * np.maximum(np.abs(wv[swapped]), 1.0)).all(), what


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_arm_rows_survive_a_selection_within_the_bound(text_setup, monkeypatch, seed):
    """tiered_dense_topk: the safe queries' rows equal the unperturbed run's
    and the JAX package's; `_msearch` as a whole (unsafe queries escalate)
    equals the unperturbed run's."""
    ref, port, queries = text_setup
    bs = port.batched()
    plans = [(p, rp) for (_, p), (_, rp) in zip(bs.plan_bucketed("body", queries, K),
                                                 ref.plan_bucketed("body", queries, K))
             if p.dense_only]
    assert plans
    base = [fetch([bs.run_fast("body", p)])[0] for p, _ in plans]
    base_ms = port.msearch("body", queries, K)
    stand_in = _Perturbed(seed)
    monkeypatch.setattr(port_batched, "tiered_candidates", stand_in)
    safe_rows = 0
    for (plan, ref_plan), want in zip(plans, base):
        got = fetch([bs.run_fast("body", plan)])[0]
        ref_rows = [np.asarray(x) for x in ref.run_fast("body", ref_plan).resolve()]
        safe = got[3].astype(bool)
        safe_rows += int(safe.sum())
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a[safe], b[safe])
        _close([x[safe] for x in got[:3]], [x[safe] for x in ref_rows[:3]], "tiered arm")
    assert safe_rows > 0 and stand_in.calls == len(plans)
    assert stand_in.swaps > 0  # BM25 ties put lanes within the bound of the kb-th
    got_ms = port.msearch("body", queries, K)
    for a, b in zip(got_ms[:3], base_ms[:3]):
        np.testing.assert_array_equal(a, b)
    assert stand_in.calls > len(plans)


@pytest.mark.parametrize("sim", ["cosine", "l2_norm"])
def test_tiered_knn_rows_survive_a_selection_within_the_bound(monkeypatch, sim):
    """TieredKnnScanner.search after its reruns: rows equal the unperturbed
    run's and the JAX package's, at kb = k + 1 (many flagged) and kb = 64."""
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(2000, 24)).astype(np.float32)
    sq = (vecs * vecs).sum(1)
    live = rng.random(2000) > 0.05
    q = rng.normal(size=(16, 24)).astype(np.float32)
    stand_in = _Perturbed(3)
    for kb, k in ((5, 4), (None, 10)):
        port = TieredKnnScanner(vecs, sq, sim, live=live, kb=kb, device="cpu")
        base = port.search(q, k)
        with monkeypatch.context() as m:
            m.setattr(port_vector, "tiered_candidates", stand_in)
            got = port.search(q, k)
        for a, b in zip(got[:3], base[:3]):
            np.testing.assert_array_equal(a, b)
        wv, wi, wt, _ = RefTieredKnnScanner(vecs, sq, sim, live=live, kb=kb).search(q, k)
        np.testing.assert_array_equal(got[2], wt)
        fin = np.isfinite(wv)
        assert np.array_equal(np.isfinite(got[0]), fin)
        # the JAX package's rows: scores within 1e-5 relative, ids up to fp-ties
        np.testing.assert_allclose(got[0][fin], wv[fin], rtol=1e-5, atol=1e-6)
        swapped = fin & (got[1] != wi)
        assert (np.abs(got[0][swapped] - wv[swapped]) <= 1e-5).all()
    assert stand_in.calls == 2
    assert port_kernels.launch_counts["tiered_candidates"] == 0  # CPU: no kernel
