"""The port's device build (`index/device_build.py`) against its host route
and the JAX package's device build, on CPU tensors.

Each stage function on CPU tensors must equal the host route of
`PackBuilder` and, where the JAX package has the function, its result run
by JAX on the CPU: `csr_blocked_scatter_device`, `analyze_hash_device` (on
a padded input) and `impact_codes_device`. A whole pack built with every
stage routed to CPU tensors (`use_device_build` replaced and the floors
lowered to 0, as the JAX package's `force_device_build` fixture does) must
be byte-equal to the host route's pack and to the JAX package's pack, and
an `EsIndex` built that way must answer as one built on the host route (1
and 3 shards; a full refresh, incremental tails and a fold). Tolerance:
none, every comparison is on bytes or equal responses.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.device_build import analyze_hash_device as ref_analyze_hash
from elasticsearch_tpu.index.device_build import csr_blocked_scatter_device as ref_scatter
from elasticsearch_tpu.index.device_build import impact_codes_device as ref_impact_codes
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu_torch.engine import EsIndex
from elasticsearch_tpu_torch.index import device_build as db
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import (POS_INF, PackBuilder, impact_codes_host)
from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

CPU = torch.device("cpu")
TEXT_ARRAYS = ["post_docids", "post_tfs", "post_dls", "term_block_start", "term_df",
               "block_max_tf", "block_min_len", "live", "dense_tfn", "pos_keys",
               "term_pos_start", "term_pos_count", "impact_codes", "impact_ubf"]
ANN_ARRAYS = ["centroids", "order", "codes", "scale", "offset"]


@pytest.fixture(autouse=True)
def _fresh_planner():
    planner_reset()
    yield
    planner_reset()


@pytest.fixture()
def force_device_build(monkeypatch):
    """Every stage on the builder's device, CPU tensors included."""
    monkeypatch.setattr(db, "DEVICE_BUILD_MIN", 0)
    monkeypatch.setattr(db, "ANALYZE_DEVICE_MIN", 0)
    monkeypatch.setattr(db, "use_device_build", lambda elements, device, floor=None:
                        device is not None)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bytes_equal(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def _flat_lanes(rng, T: int, N: int, block: int = 128):
    df = rng.integers(1, 300, T)
    offsets = np.concatenate([[0], np.cumsum(df)])
    nblk = (df + block - 1) // block
    row_base = np.concatenate([[1], 1 + np.cumsum(nblk)])
    term = np.repeat(np.arange(T), df)
    local = np.arange(offsets[-1]) - np.repeat(offsets[:-1], df)
    dest_row = row_base[:-1][term] + local // block
    dest_col = local % block
    docs = np.concatenate([np.sort(rng.choice(N, d, replace=False)) for d in df]).astype(np.int32)
    tfs = rng.integers(1, 9, offsets[-1]).astype(np.float32)
    dls = (rng.integers(1, 60, offsets[-1]) * 1.0).astype(np.float32)
    return docs, tfs, dls, dest_row, dest_col, int(row_base[-1])


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_blocked_scatter_matches_host_and_reference(seed):
    rng = np.random.default_rng(seed)
    N, B = 2000, 128
    fd, ft, fl, dr, dc, TB = _flat_lanes(rng, 40, N)
    got = db.csr_blocked_scatter_device(*(torch.from_numpy(a) for a in (fd, ft, fl, dr, dc)),
                                        TB, B, N)
    want = ref_scatter(fd, ft, fl, dr, dc, TB, B, N)
    pdh = np.full((TB, B), N, np.int32)
    pth = np.zeros((TB, B), np.float32)
    plh = np.ones((TB, B), np.float32)
    bmh = np.zeros(TB, np.float32)
    blh = np.full(TB, np.inf, np.float32)
    pdh[dr, dc], pth[dr, dc], plh[dr, dc] = fd, ft, fl
    starts = np.flatnonzero(np.diff(dr, prepend=-1))
    bmh[dr[starts]] = np.maximum.reduceat(ft, starts)
    blh[dr[starts]] = np.minimum.reduceat(fl, starts)
    for name, g, w, h in zip(("docids", "tfs", "dls", "block_max_tf", "block_min_len"),
                             got, want, (pdh, pth, plh, bmh, blh)):
        _bytes_equal(g, h, name)
        _bytes_equal(g, w, name)


def _padded_texts(rng, B: int, L: int):
    alphabet = np.frombuffer(b"abcXYZ019'' ._-\t'q", np.uint8)
    chars = alphabet[rng.integers(0, len(alphabet), (B, L))]
    lengths = rng.integers(0, L + 1, B)
    lengths[0], lengths[1] = L, 0
    chars[np.arange(L)[None, :] >= lengths[:, None]] = 0
    chars[2, :] = ord("a")  # one long token across the whole row
    return chars, lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyze_hash_device_matches_reference(seed):
    rng = np.random.default_rng(seed)
    chars, lengths = _padded_texts(rng, 37, 90)
    got = db.analyze_hash_device(chars, lengths, CPU)
    want = ref_analyze_hash(chars, lengths.astype(np.int32))
    for name, g, w in zip(("start", "end", "joiner", "h1", "h2"), got, want):
        _bytes_equal(g, w, name)


def test_stream_tokens_match_the_padded_form():
    """The flat stream's per-token hashes are the padded form's at each end."""
    rng = np.random.default_rng(5)
    chars, lengths = _padded_texts(rng, 25, 70)
    start, end, _j, h1, h2 = db.analyze_hash_device(chars, lengths, CPU)
    valid = np.arange(70)[None, :] < lengths[:, None]
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    r = db.tokenize_hash_stream(torch.from_numpy(chars[valid]), torch.from_numpy(offsets))
    er, ec = np.nonzero(end)
    sr, sc = np.nonzero(start)
    assert np.array_equal(r["value"].numpy(), er) and np.array_equal(sr, er)
    assert np.array_equal(r["start"].numpy(), offsets[sr] + sc)
    assert np.array_equal(r["end"].numpy(), offsets[er] + ec)
    assert np.array_equal(r["h1"].numpy(), h1[er, ec].astype(np.int64))
    assert np.array_equal(r["h2"].numpy(), h2[er, ec].astype(np.int64))


@pytest.mark.parametrize("exact_products", [True, False], ids=["exact_k", "real_k"])
@pytest.mark.parametrize("dtype", ["uint16", "int8"])
def test_impact_codes_device_matches_host_and_reference(dtype, exact_products):
    """Equal to the host route always. Equal to the JAX package's function
    where k_slope * dl is exact in f32 (XLA on the CPU contracts
    k_base + k_slope * dl into one FMA, the host route and the port round
    the product first); with real k_slope, within one code on at most 0.1%
    of the lanes."""
    rng = np.random.default_rng(3)
    nb, qmax = 300, {"uint16": 65535, "int8": 127}[dtype]
    tfs = np.where(rng.random((nb, 128)) < 0.7, rng.integers(1, 12, (nb, 128)), 0).astype(np.float32)
    dls = rng.integers(1, 300, (nb, 128)).astype(np.float32)
    k_base = rng.uniform(0.3, 1.2, nb).astype(np.float32)
    if exact_products:  # 9-bit integers times 2^-14: every product exact
        k_slope = (rng.integers(0, 330, nb) / 16384.0).astype(np.float32)
    else:
        k_slope = rng.uniform(0.0, 0.02, nb).astype(np.float32)
    scale_inv = rng.uniform(1.0, qmax * 1.5, nb).astype(np.float32)
    got = db.impact_codes_device(*(torch.from_numpy(a) for a in (tfs, dls, k_base, k_slope,
                                                                  scale_inv)),
                                 qmax=qmax, dtype=dtype)
    host = impact_codes_host(tfs, dls, k_base, k_slope, scale_inv, qmax, dtype)
    ref = np.asarray(ref_impact_codes(tfs, dls, k_base, k_slope, scale_inv, qmax=qmax,
                                      dtype=dtype))
    _bytes_equal(got, host, "host")
    if exact_products:
        _bytes_equal(got, ref, "reference")
    else:
        diff = np.abs(got.numpy().astype(np.int64) - ref.astype(np.int64))
        assert diff.max() <= 1 and np.count_nonzero(diff) <= diff.size // 1000


def test_flat_csr_and_positions_match_numpy():
    rng = np.random.default_rng(8)
    N, T = 500, 60
    tids = rng.integers(0, T, 20000)
    docs = np.sort(rng.integers(0, N, 20000))
    fd, ft, df = db.flat_csr_device(torch.from_numpy(tids), torch.from_numpy(docs), N, T)
    uk, tf = np.unique(tids * N + docs, return_counts=True)
    _bytes_equal(fd, (uk % N).astype(np.int32), "flat_docs")
    _bytes_equal(ft, tf.astype(np.float32), "flat_tfs")
    _bytes_equal(df, np.bincount(uk // N, minlength=T), "df")
    keys = docs * 1000 + np.arange(20000) % 1000
    fp, cnt = db.sort_positions_device(torch.from_numpy(tids), torch.from_numpy(keys), T)
    _bytes_equal(fp, keys[np.argsort(tids, kind="stable")], "flat_pos")
    _bytes_equal(cnt, np.bincount(tids, minlength=T), "pos_count")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(tids, minlength=T))])
    prow = np.concatenate([[1], 1 + np.cumsum((np.diff(offsets) + 127) // 128)])
    blocks = db.position_blocks_device(fp, torch.from_numpy(offsets), torch.from_numpy(prow),
                                       128, int(POS_INF))
    want = np.full((int(prow[-1]), 128), POS_INF, np.int64)
    pdf = np.diff(offsets)
    local = np.arange(offsets[-1]) - np.repeat(offsets[:-1], pdf)
    want[np.repeat(prow[:-1], pdf) + local // 128, local % 128] = fp.numpy()
    _bytes_equal(blocks, want, "pos_keys")


def test_use_device_build_routes_the_card_above_the_floors():
    cuda = torch.device("cuda", 0)
    assert not db.use_device_build(1 << 30, CPU)
    assert not db.use_device_build(1 << 30, None)
    assert db.use_device_build(db.DEVICE_BUILD_MIN, cuda)
    assert not db.use_device_build(db.DEVICE_BUILD_MIN - 1, cuda)
    assert db.use_device_build(db.ANALYZE_DEVICE_MIN, cuda, db.ANALYZE_DEVICE_MIN)
    assert not db.use_device_build(db.ANALYZE_DEVICE_MIN - 1, cuda, db.ANALYZE_DEVICE_MIN)
    assert (db.DEVICE_BUILD_MIN, db.ANALYZE_DEVICE_MIN) == (32768, 65536)


# ---------------------------------------------------------------------------
# whole packs
# ---------------------------------------------------------------------------

MAPPING = {"properties": {
    "body": {"type": "text"}, "title": {"type": "text"}, "n": {"type": "long"},
    "tag": {"type": "keyword"}, "short": {"type": "keyword", "ignore_above": 3},
    "vec": {"type": "dense_vector", "dims": 8, "index_options": {"type": "ivf", "nlist": 6}},
}}


def _docs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(150)] + ["don't", "Rock'n'Roll", "CAFÉ", "naïve", "x_y",
                                             "O'Neil", "it’s", "日本語", "'lead", "trail'"]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    out = []
    for i in range(n):
        body = " ".join(rng.choice(words, int(rng.integers(0, 25)), p=p))
        d = {"body": body, "n": int(rng.integers(0, 50)), "tag": f"k{int(rng.integers(0, 9))}",
             "short": "x" * int(rng.integers(1, 6))}
        if i % 11 == 0:
            d["tag"] = ["k1", "k2", "k1"]  # multi-valued: the per-doc keyword path
        if i % 7 == 0:
            d["body"] = [body, "", f"second value w{i % 5} w1"]
        if i % 5 != 0:
            d["title"] = " ".join(rng.choice(words[:30], 3))
        if i % 3:
            d["vec"] = rng.normal(size=8).round(3).tolist()
        out.append(d)
    out[3]["body"] = "z" * 300 + " tail"  # an overlong token
    out[4]["body"] = " ".join(f"w{i % 40}" for i in range(131_100))  # past POS_L - 64
    out[6]["body"] = "!!! ???"  # no token
    return out


def _port_pack(docs, device, batch=True):
    m = Mappings(MAPPING)
    b = PackBuilder(m, device=device)
    parsed = [m.parse_document(d) for d in docs]
    ids = [f"id{i}" for i in range(len(docs))]
    if batch:
        b.add_documents_batch(parsed, doc_ids=ids)
    else:
        for p, i in zip(parsed, ids):
            b.add_document(p, doc_id=i)
    return b.build(dense_min_df=40, device=CPU)


def _assert_packs_equal(got, want, ann: bool = True):
    assert got.num_docs == want.num_docs
    for name in TEXT_ARRAYS:
        _bytes_equal(getattr(got, name), getattr(want, name), name)
    assert list(got.term_dict) == list(want.term_dict) and got.term_dict == want.term_dict
    assert got.field_stats == want.field_stats and got.dense_dict == want.dense_dict
    assert set(got.norms) == set(want.norms)
    for f in want.norms:
        _bytes_equal(got.norms[f], want.norms[f], f)
        _bytes_equal(got.text_present[f], want.text_present[f], f)
    assert set(got.docvalues) == set(want.docvalues)
    for f, col in want.docvalues.items():
        pc = got.docvalues[f]
        assert pc.kind == col.kind and pc.ord_terms == col.ord_terms, f
        _bytes_equal(pc.values, col.values, f)
        _bytes_equal(pc.has_value, col.has_value, f)
    if ann:
        for f, vc in want.vectors.items():
            _bytes_equal(got.vectors[f].values, vc.values, f)
            for k in ANN_ARRAYS:
                _bytes_equal(got.vectors[f].ann[k], vc.ann[k], k)


@pytest.fixture(scope="module")
def docs():
    return _docs(4, 1500)


@pytest.fixture(scope="module")
def host_pack(docs):
    return _port_pack(docs, None)


def test_device_routed_pack_byte_equal_host_route(docs, host_pack, force_device_build):
    got = _port_pack(docs, CPU)
    assert isinstance(got.dense_tfn, torch.Tensor)  # the device tier stays resident
    _assert_packs_equal(got, host_pack)


def test_device_routed_pack_byte_equal_reference(docs, force_device_build):
    got = _port_pack(docs, CPU)
    m = RefMappings(MAPPING)
    b = RefPackBuilder(m)
    b.add_documents_batch([m.parse_document(d) for d in docs],
                          doc_ids=[f"id{i}" for i in range(len(docs))])
    ref = b.build(dense_min_df=40)
    _assert_packs_equal(got, ref, ann=False)


def test_device_route_after_per_doc_adds(docs, host_pack, force_device_build):
    """Per-document adds, then a burst: the chunks keep stream order."""
    m = Mappings(MAPPING)
    b = PackBuilder(m, device=CPU)
    parsed = [m.parse_document(d) for d in docs]
    for i, p in enumerate(parsed[:300]):
        b.add_document(p, doc_id=f"id{i}")
    b.add_documents_batch(parsed[300:], doc_ids=[f"id{i}" for i in range(300, len(docs))])
    _assert_packs_equal(b.build(dense_min_df=40, device=CPU), host_pack)


def test_host_route_batch_equals_per_doc(docs, host_pack):
    _assert_packs_equal(_port_pack(docs, None, batch=False), host_pack)


def test_device_routed_pack_records_device_basis(docs, force_device_build):
    from elasticsearch_tpu_torch.monitoring.refresh_profile import collect_build_stages

    with collect_build_stages() as c:
        _port_pack(docs[:200], CPU)
    wall, stages = c.finish()
    assert c.bases == {"build.analyze": "device", "flat_csr": "device",
                       "build.csr_assemble": "device", "build.impact_quantize": "device",
                       "dense_tier": "device", "positions": "device",
                       "build.kmeans": "device", "build.ann_tiles": "device"}
    assert {"build.norms", "docvalues", "vectors", "build.kmeans",
            "build.ann_tiles"} <= set(stages)
    assert abs(sum(stages.values()) - wall) <= 1e-9 * max(wall, 1.0)


# ---------------------------------------------------------------------------
# EsIndex answers
# ---------------------------------------------------------------------------

QUERIES = [
    {"match": {"body": "w1 w2 w7"}}, {"match": {"body": "don't rock'n'roll"}},
    {"match_phrase": {"body": "w1 w2"}}, {"match": {"title": "w3"}},
    {"bool": {"must": [{"match": {"body": "w4"}}], "filter": [{"term": {"tag": "k3"}}]}},
    {"range": {"n": {"gte": 10, "lt": 30}}}, {"match": {"body": "café naïve"}},
]


def _answers(docs, shards: int) -> list:
    """Responses of a write script: a full refresh, incremental tails past
    the segment bound (so a fold runs), then a merge through `searcher`."""
    idx = EsIndex("x", MAPPING, settings={"number_of_shards": shards}, device="cpu")
    out = []
    for i, d in enumerate(docs[:800]):
        idx.index_doc(f"d{i}", d)
    idx.refresh()
    kinds = [idx.last_refresh_kind]
    out += [idx.search(q, size=15) for q in QUERIES]
    for r in range(6):
        for j in range(40):
            idx.index_doc(f"d{(r * 97 + j * 13) % 800}" if j % 4 else f"n{r}_{j}",
                          docs[800 + r * 40 + j])
        idx.delete_doc(f"d{r + 1}")
        idx.refresh()
        kinds.append(idx.last_refresh_kind)
        out += [idx.search(q, size=15) for q in QUERIES[:3]]
    out.append(idx.counters.get("segment_merge_total", 0))
    out += [idx.search(q, size=15) for q in QUERIES]
    idx.searcher  # the major merge
    out += [idx.search(q, size=15) for q in QUERIES]
    out.append(kinds)
    return out


def _strip(r):
    if isinstance(r, dict):
        return {k: _strip(v) for k, v in r.items() if k != "took"}
    if isinstance(r, list):
        return [_strip(v) for v in r]
    return r


@pytest.mark.parametrize("shards", [1, 3])
def test_esindex_answers_equal_host_build(docs, shards, monkeypatch):
    want = _answers(docs, shards)
    planner_reset()
    monkeypatch.setattr(db, "DEVICE_BUILD_MIN", 0)
    monkeypatch.setattr(db, "ANALYZE_DEVICE_MIN", 0)
    monkeypatch.setattr(db, "use_device_build", lambda e, d, floor=None: d is not None)
    got = _answers(docs, shards)
    assert want[-1][0] == "full" and "incremental" in want[-1]
    assert _strip(got) == _strip(want)


def _tiered_index(docs, device_route: bool, monkeypatch):
    """A one-shard index of 800 docs, then 40 new docs refreshed as a tail
    segment (the base re-derives its dense tier under the combined
    statistics)."""
    if device_route:
        monkeypatch.setattr(db, "DEVICE_BUILD_MIN", 0)
        monkeypatch.setattr(db, "ANALYZE_DEVICE_MIN", 0)
        monkeypatch.setattr(db, "use_device_build", lambda e, d, floor=None: d is not None)
    idx = EsIndex("x", MAPPING, device="cpu")
    for i, d in enumerate(docs[:800]):
        idx.index_doc(f"d{i}", d)
    idx.refresh()
    built = idx._searcher.pack.dense_tfn
    for j in range(40):
        idx.index_doc(f"n{j}", docs[800 + j])
    idx.refresh()
    assert idx.last_refresh_kind == "incremental" and idx._searcher.stats_override is not None
    return idx, built


def test_device_built_tier_is_rewritten_in_place_under_an_override(docs, monkeypatch):
    """A device-built dense tier is the pack's tensor and the searcher's:
    the statistics override of an incremental refresh rewrites it in place
    (one tier, not a second beside the pack's), to the values the host
    route's index derives; a host pack's array stays as it was built."""
    host, host_built = _tiered_index(docs, False, monkeypatch)
    host_copy = host_built.copy()
    dev, dev_built = _tiered_index(docs, True, monkeypatch)
    assert isinstance(dev_built, torch.Tensor)
    assert dev._searcher.dev["dense_tfn"] is dev_built is dev._searcher.pack.dense_tfn
    _bytes_equal(dev._searcher.dev["dense_tfn"], host._searcher.dev["dense_tfn"], "dense_tfn")
    assert isinstance(host._searcher.pack.dense_tfn, np.ndarray)
    assert host._searcher.pack.dense_tfn.tobytes() == host_copy.tobytes()
    assert not np.shares_memory(host._searcher.dev["dense_tfn"].numpy(), host_built)
