"""The port's scan_topk against the JAX package's, on the same numpy inputs.

On a CPU tensor the port's `scan_topk` runs its PyTorch twin
`scan_topk_reference`; it is held against the JAX `scan_topk` in interpret
mode (the Pallas kernel body) and against `scan_topk_xla`, over the cases
of tests/test_kernels.py merged into one parametrised test.

Tolerances: streamed mode with the identity transform sees the same f32
scores, so values are equal; with another transform, XLA on the CPU
contracts a*b + c into one FMA where the twin rounds twice, so values agree
within 2 ulp (rtol 2.5e-7). In matmul mode XLA's dot and the twin's
d = 0..D-1 chain of fmas (`_fma_dots`) add in different orders, so values
are held to the JAX package's own kernel-test tolerance (rtol 1e-5, atol
1e-6). Ids are equal wherever the score is finite; totals are equal.
`_fma_dots` itself is held to an exact oracle: each fma of the chain
computed in rationals (`fractions.Fraction`) and rounded to the nearest f32,
ties to even.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds
it against this twin there.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.kernels import scan_topk as jax_scan_topk
from elasticsearch_tpu.ops.kernels import scan_topk_xla
from elasticsearch_tpu_torch.ops import kernels as port_kernels
from elasticsearch_tpu_torch.ops.kernels import scan_topk
from elasticsearch_tpu_torch.ops.scoring import top_k_with_total

TRANSFORMS = ["identity", "cosine", "dot_product", "l2_norm", "max_inner_product"]


def _aux(transform, q, vecs):
    """Per-doc and per-query transform inputs (ops/vector.py conventions)."""
    N, B = vecs.shape[0], q.shape[0]
    sq = (vecs * vecs).sum(-1)
    if transform == "cosine":
        return (1.0 / np.sqrt(np.maximum(sq, 1e-30)),
                1.0 / np.sqrt(np.maximum((q * q).sum(-1), 1e-30)))
    if transform == "l2_norm":
        return sq, (q * q).sum(-1)
    return np.zeros(N), np.zeros(B)


def _case(name, rng):
    """-> (q or None, mat_t, live, k, kwargs) for one named case."""
    if name == "matmul_identity_basic":
        B, D, N = 5, 16, 300
        q = rng.normal(size=(B, D)).astype(np.float32)
        mat = np.abs(rng.normal(size=(D, N))).astype(np.float32)
        live = np.ones(N, bool)
        live[rng.choice(N, 40, replace=False)] = False
        return q, mat, live, 10, {}
    if name == "streamed":
        scores = rng.normal(size=(9, 700)).astype(np.float32)
        return None, scores, rng.random(700) > 0.3, 7, {}
    if name == "streamed_ties":
        scores = np.round(rng.normal(size=(3, 900)), 2).astype(np.float32)
        return None, scores, rng.random(900) > 0.2, 25, {"count_positive": False}
    if name == "tie_break_lowest_docid":
        return None, np.ones((2, 257), np.float32), np.ones(257, bool), 5, {}
    if name == "k_larger_than_matches":
        scores = np.full((3, 40), -1.0, np.float32)
        scores[:, 3] = 2.0
        live = np.zeros(40, bool)
        live[:8] = True
        return None, scores, live, 6, {"count_positive": True}
    if name == "matmul_depth_384":  # the dense kNN scan's depth
        B, D, N = 3, 384, 300
        q = rng.normal(size=(B, D)).astype(np.float32)
        mat = rng.normal(size=(D, N)).astype(np.float32)
        return q, mat, rng.random(N) > 0.1, 10, {"count_positive": False}
    if name == "unaligned_shapes":
        B, D, N = 11, 7, 1037
        q = rng.normal(size=(B, D)).astype(np.float32)
        mat = rng.normal(size=(D, N)).astype(np.float32)
        return q, mat, rng.random(N) > 0.5, 13, {"count_positive": False}
    if name.startswith("transform_"):
        mode, transform = name[len("transform_"):].split("-")
        B, D, N = 4, 8, 130
        q = rng.normal(size=(B, D)).astype(np.float32)
        vecs = rng.normal(size=(N, D)).astype(np.float32)
        aux_doc, aux_q = _aux(transform, q, vecs)
        kw = {"transform": transform, "aux_doc": aux_doc.astype(np.float32),
              "aux_q": aux_q.astype(np.float32), "count_positive": False}
        if mode == "streamed":
            # precomputed dots through the streamed path of the same transform
            return None, (q @ vecs.T).astype(np.float32), np.ones(N, bool), 5, kw
        return q, vecs.T.copy(), np.ones(N, bool), 5, kw
    raise KeyError(name)


CASES = (
    ["matmul_identity_basic", "streamed", "streamed_ties",
     "tie_break_lowest_docid", "k_larger_than_matches", "unaligned_shapes",
     "matmul_depth_384"]
    + [f"transform_{m}-{t}" for m in ("matmul", "streamed") for t in TRANSFORMS]
)


def _jax_arms(q, mat_t, live, k, kw):
    B = mat_t.shape[0] if q is None else q.shape[0]
    N = mat_t.shape[1]
    jq = None if q is None else jnp.asarray(q)
    aux_doc = kw.get("aux_doc", np.zeros(N, np.float32))
    aux_q = kw.get("aux_q", np.zeros(B, np.float32))
    interp = jax_scan_topk(jq, jnp.asarray(mat_t), jnp.asarray(live), k,
                           interpret=True, **kw)
    xla = scan_topk_xla(jq, jnp.asarray(mat_t), jnp.asarray(live),
                        jnp.asarray(aux_doc), jnp.asarray(aux_q), k=k,
                        transform=kw.get("transform", "identity"),
                        count_positive=kw.get("count_positive", True))
    return [[np.asarray(x) for x in arm] for arm in (interp, xla)]


def _port(q, mat_t, live, k, kw):
    tkw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for key, v in kw.items()}
    out = scan_topk(None if q is None else torch.from_numpy(q),
                    torch.from_numpy(mat_t), torch.from_numpy(live), k, **tkw)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("case", CASES)
def test_scan_topk_matches_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    q, mat_t, live, k, kw = _case(case, rng)
    before = dict(port_kernels.launch_counts)
    gv, gi, gt = _port(q, mat_t, live, k, kw)
    assert port_kernels.launch_counts == before  # CPU tensors: no kernel launch
    for wv, wi, wt in _jax_arms(q, mat_t, live, k, kw):
        if q is None and kw.get("transform", "identity") == "identity":
            np.testing.assert_array_equal(gv, wv)
        elif q is None:
            # XLA on the CPU contracts the transform's a*b + c into one FMA
            np.testing.assert_allclose(gv, wv, rtol=2.5e-7, atol=0)
        else:
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)
        finite = np.isfinite(wv)
        np.testing.assert_array_equal(np.isfinite(gv), finite)
        np.testing.assert_array_equal(gi[finite], wi[finite])
        np.testing.assert_array_equal(gt, wt)
    if case == "tie_break_lowest_docid":
        np.testing.assert_array_equal(gi, np.tile(np.arange(5), (2, 1)))


@pytest.mark.parametrize("k", [9, 128, 150])
@pytest.mark.parametrize("fused", ["force", "0"])
def test_top_k_with_total_matches_jax(monkeypatch, k, fused):
    """ES_TPU_FUSED_TOPK=force selects through the JAX streamed scan
    (interpret mode), =0 through lax.top_k; the port selects through
    scan_topk for k <= 128 and a stable sort above."""
    from elasticsearch_tpu.ops.scoring import top_k_with_total as jax_topk

    rng = np.random.default_rng(k)
    n = 700
    scores = np.round(rng.normal(size=n + 1), 2).astype(np.float32)  # many ties
    match = rng.random(n + 1) > 0.2
    live = rng.random(n) > 0.3
    monkeypatch.setenv("ES_TPU_FUSED_TOPK", fused)
    wv, wi, wt = [np.asarray(x) for x in jax_topk(
        jnp.asarray(scores), jnp.asarray(match), jnp.asarray(live), k)]
    gv, gi, gt = [x.numpy() for x in top_k_with_total(
        torch.from_numpy(scores), torch.from_numpy(match), torch.from_numpy(live), k)]
    np.testing.assert_array_equal(gv, wv)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(gi[finite], wi[finite])
    assert int(gt) == int(wt)


def _rn_f32(x: Fraction) -> np.float32:
    """The f32 nearest to the rational x, ties to the even significand."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        dist = abs(Fraction(float(c)) - x)
        if best is None or dist < best[0] or (dist == best[0] and int(c.view(np.int32)) % 2 == 0):
            best = (dist, c)
    return best[1]


def test_fma_dots_matches_exact_fma_chain():
    """Every lane of `_fma_dots` equals acc = RN(q[r, d] * m[d, n] + acc),
    d = 0 .. D-1 from +0.0, with each step rounded once from the exact
    rational: on a draw whose exponents span 2^-75 .. 2^19, with a query
    row and doc columns scaled into the subnormal range."""
    rng = np.random.default_rng(5)
    B, D, N = 4, 64, 257
    q = rng.normal(size=(B, D)) * 2.0 ** rng.integers(-75, 20, size=(B, D))
    m = rng.normal(size=(D, N)) * 2.0 ** rng.integers(-75, 20, size=(D, N))
    q[3] = rng.normal(size=D) * 2.0 ** -70
    m[:, :16] = rng.normal(size=(D, 16)) * 2.0 ** -70
    q, m = q.astype(np.float32), m.astype(np.float32)
    got = port_kernels._fma_dots(torch.from_numpy(q), torch.from_numpy(m)).numpy()
    tiny = np.finfo(np.float32).tiny
    assert ((np.abs(got) < tiny) & (got != 0)).any()  # subnormal results are covered
    qf = [[Fraction(float(v)) for v in row] for row in q]
    mf = [[Fraction(float(v)) for v in row] for row in m.T]
    for r in range(B):
        for n in range(N):
            acc = np.float32(0.0)
            for d in range(D):
                acc = _rn_f32(qf[r][d] * mf[n][d] + Fraction(float(acc)))
            assert acc.view(np.int32) == got[r, n].view(np.int32), (r, n, acc, got[r, n])


def test_fma_dots_rounds_each_step_once():
    """The D = 2 dot with q = m = [2^-30, 1 + 2^-12]: the first fma leaves
    acc = 2^-60, the second rounds 1 + 2^-11 + 2^-24 + 2^-60 up to
    1 + 2^-11 + 2^-23. The f64 dot cast once to f32 loses the 2^-60 and
    rounds the tie to even, 1 + 2^-11."""
    v = torch.tensor([[2.0 ** -30, 1.0 + 2.0 ** -12]], dtype=torch.float32)
    got = port_kernels._fma_dots(v, v.T.contiguous())
    assert got.item() == 1.0 + 2.0 ** -11 + 2.0 ** -23
    assert (v.double() @ v.T.double()).float().item() == 1.0 + 2.0 ** -11


@pytest.mark.parametrize("mode", ["streamed", "matmul"])
def test_scan_topk_empty_tier(mode):
    """Zero docs (an empty tier) or zero rows: no lanes, totals 0, chosen
    by shape before the twin (the kernel's wrapper launches nothing)."""
    for B, N in ((3, 0), (0, 0), (0, 50)):
        q = None if mode == "streamed" else torch.ones((B, 8))
        mat = torch.ones((B, N)) if mode == "streamed" else torch.ones((8, N))
        v, i, t = scan_topk(q, mat, torch.ones(N, dtype=torch.bool), 10, transform="cosine")
        assert v.shape == (B, 0) and i.shape == (B, 0) and i.dtype == torch.int32
        assert t.dtype == torch.int32 and t.tolist() == [0] * B


def test_scan_topk_rejects_unknown_transform():
    with pytest.raises(ValueError, match="unknown transform"):
        scan_topk(None, torch.zeros((1, 4)), torch.ones(4, dtype=torch.bool), 2,
                  transform="bogus")


# ---------------------------------------------------------------------------
# split_bf16, tiered_candidates and impact_gather
#
# split_bf16 is integer masking plus one rounding cast on both sides, so the
# halves are byte-equal. tiered_candidates: every bf16 x bf16 product is
# exact in f32, but XLA's dot and the twin's sequential d = 0..D-1 sums add
# in different orders, so selection values are held to the JAX package's
# own tiered test tolerance (rtol 1e-6, atol 1e-7, tests/test_kernels.py),
# ids equal on finite lanes except ties within it, totals equal.
# impact_gather is one f32 multiply per lane on both sides: equal.
# ---------------------------------------------------------------------------


def test_split_bf16_matches_jax():
    from elasticsearch_tpu.ops.kernels import split_bf16 as jax_split

    rng = np.random.default_rng(3)
    mat = rng.normal(size=(17, 300)).astype(np.float32)
    mat[0, :50] = np.abs(mat[0, :50]) * 1e-30  # tiny and subnormal residuals
    mat[1, :50] = 0.0
    mat[2, :50] = np.float32(3.0e38)
    hi, lo = port_kernels.split_bf16(torch.from_numpy(mat))
    want_hi, want_lo = (np.asarray(x).view(np.uint16) for x in jax_split(jnp.asarray(mat)))
    assert hi.view(torch.int16).numpy().view(np.uint16).tobytes() == want_hi.tobytes()
    assert lo.view(torch.int16).numpy().view(np.uint16).tobytes() == want_lo.tobytes()


@pytest.mark.parametrize("dtype", ["uint16", "int8"])
def test_impact_gather_matches_jax(dtype):
    from elasticsearch_tpu.ops.kernels import _impact_gather_xla
    from elasticsearch_tpu.ops.kernels import impact_gather as jax_gather

    rng = np.random.default_rng(7)
    nb, n_docs = 17, 5000
    high = 65536 if dtype == "uint16" else 128
    codes = rng.integers(0, high, (nb, 128)).astype(dtype)
    codes[0] = 0
    dids = rng.integers(0, n_docs, (nb, 128)).astype(np.int32)
    dids[0] = n_docs  # row 0: the all-padding block
    rows = rng.integers(0, nb, (3, 11)).astype(np.int32)
    rows[:, -2:] = 0  # padding rows, weight 0
    w = rng.random((3, 11), np.float32)
    w[:, -2:] = 0.0
    before = dict(port_kernels.launch_counts)
    gi, gs = [x.numpy() for x in port_kernels.impact_gather(
        *(torch.from_numpy(a) for a in (codes, dids, rows, w)))]
    assert port_kernels.launch_counts == before  # CPU tensors: no kernel launch
    args = [jnp.asarray(a) for a in (codes, dids, rows, w)]
    lanes = rows.shape[1] * 128
    for wi, ws in (_impact_gather_xla(*args), jax_gather(*args, interpret=True)):
        # the Pallas arm pads R to its DMA group of 8 rows with row 0
        wi, ws = np.asarray(wi), np.asarray(ws)
        assert (wi[:, lanes:] == n_docs).all() and (ws[:, lanes:] == 0).all()
        np.testing.assert_array_equal(gi, wi[:, :lanes])
        np.testing.assert_array_equal(gs, ws[:, :lanes])
    assert (gi[:, -256:] == n_docs).all() and (gs[:, -256:] == 0).all()


TIERED_CASES = [(t, cp) for t in TRANSFORMS for cp in (True, False)]


@pytest.mark.parametrize("transform,count_positive", TIERED_CASES,
                         ids=[f"{t}-{'positive' if cp else 'live'}" for t, cp in TIERED_CASES])
def test_tiered_candidates_matches_jax(transform, count_positive):
    from elasticsearch_tpu.ops.kernels import _tiered_candidates_xla, _mask_hi
    from elasticsearch_tpu.ops.kernels import split_bf16 as jax_split
    from elasticsearch_tpu.ops.kernels import tiered_candidates as jax_tiered

    rng = np.random.default_rng(TIERED_CASES.index((transform, count_positive)))
    B, D, N, kb = 6, 32, 900, 16
    q = rng.normal(size=(B, D)).astype(np.float32)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    mat = np.abs(vecs.T) if transform == "identity" else vecs.T.copy()
    live = rng.random(N) > 0.25
    aux_doc, aux_q = (a.astype(np.float32) for a in _aux(transform, q, vecs))
    hi, lo = jax_split(jnp.asarray(mat))
    kw = {"transform": transform, "count_positive": count_positive}
    jargs = (jnp.asarray(live), jnp.asarray(aux_doc), jnp.asarray(aux_q))
    xla = _tiered_candidates_xla(_mask_hi(jnp.asarray(q)).astype(jnp.bfloat16), hi, lo,
                                 *jargs, kb=kb, **kw)
    interp = jax_tiered(jnp.asarray(q), hi, lo, jargs[0], kb, aux_doc=jargs[1],
                        aux_q=jargs[2], interpret=True, **kw)
    phi, plo = port_kernels.split_bf16(torch.from_numpy(mat))
    before = dict(port_kernels.launch_counts)
    gv, gi, gt = [x.numpy() for x in port_kernels.tiered_candidates(
        torch.from_numpy(q), phi, plo, torch.from_numpy(live), kb,
        aux_doc=torch.from_numpy(aux_doc), aux_q=torch.from_numpy(aux_q), **kw)]
    assert port_kernels.launch_counts == before
    for arm in (xla, interp):
        wv, wi, wt = [np.asarray(x) for x in arm]
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-7)
        finite = np.isfinite(wv)
        np.testing.assert_array_equal(np.isfinite(gv), finite)
        swapped = finite & (gi != wi)
        # a swap is a tie: the two lanes' values agree within the tolerance
        np.testing.assert_allclose(gv[swapped], wv[swapped], rtol=1e-6, atol=1e-7)
        assert swapped.sum() <= 2
        np.testing.assert_array_equal(gt, wt)
