"""The port's search templates (`search/templates.py`) and stored scripts
(`Engine.stored_scripts`, the `_scripts/{id}` routes) against the JAX
package's.

The renderer's cases (variables, dotted paths, `toJson`, inverted
sections, escaping, the errors) run through both packages. The
reference's tests/test_runtime_querystring.py::test_search_templates and
the stored-script routes run through both REST apps. Then seeded indices
on 1 and 3 shards, on a fresh base and after a tiered refresh (new docs,
updates, deletes): stored and inline templates with `from`, `size`,
`sort`, `aggs` and `highlight` through `_search/template`,
`_msearch/template` (with per-entry errors) and `_render/template`, each
answer held to the reference's and to the port's plain `_search` of the
rendered body. Last, the divergence: the port keeps stored scripts in
memory, so a new engine starts without them; the reference saves them to
its data path.

Tolerances: rendered text, template output, statuses and error envelopes
`==`; search answers by `torch_parity.same_hits` (totals equal, scores
within 1e-6 relative, ids up to fp-ties), highlights and aggregations
`==`, and the port's templated answer `==` its plain `_search` but for
`took`.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.search import templates as ref_templates
from elasticsearch_tpu.utils.errors import ElasticsearchTpuError as RefError
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.search import templates
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuError
from torch_parity import MAPPING, rest_both, same_hits, text_docs


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")


class _Store:
    stored_scripts = {"s1": {"lang": "mustache",
                             "source": '{"query": {"match": {"body": "{{q}}"}}}'},
                      "obj": {"lang": "mustache", "source": {"query": {"match_all": {}}}}}


RENDER = {
    "var": ('{"size": {{n}}}', {"n": 3}),
    "string_escaped": ('{"q": "{{s}}"}', {"s": 'say "hi"\\ now\n'}),
    "bool_true": ('{"b": {{flag}}}', {"flag": True}),
    "bool_false": ('{"b": {{flag}}}', {"flag": False}),
    "float": ('{"x": {{x}}}', {"x": 2.5}),
    "missing_is_empty": ('{"q": "{{nope}}"}', {}),
    "dotted": ('{"q": "{{a.b.c}}"}', {"a": {"b": {"c": "deep"}}}),
    "dotted_missing": ('{"q": "{{a.x.c}}"}', {"a": {"b": 1}}),
    "to_json_list": ('{"terms": {{#toJson}}ns{{/toJson}}}', {"ns": [1, "two", None]}),
    "to_json_obj": ('{"q": {{#toJson}} q.inner {{/toJson}}}', {"q": {"inner": {"k": [1]}}}),
    "inverted_absent": ('{"from": {{f}}{{^f}}0{{/f}}}', {}),
    "inverted_present": ('{"from": {{f}}{{^f}}0{{/f}}}', {"f": 7}),
    "inverted_multiline": ('{"q": 1{{^x}},\n"size": 2{{/x}}}', None),
    "dict_source": ({"query": {"match": {"body": "{{q}}"}}}, {"q": "w1"}),
    "bad_source": (17, {}),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ElasticsearchTpuError, RefError) as ex:
        return ("error", ex.status, ex.type, ex.reason)


@pytest.mark.parametrize("case", sorted(RENDER))
def test_render_template_cases_match_reference(case):
    source, params = RENDER[case]
    got = _outcome(lambda: templates.render_template(source, params))
    want = _outcome(lambda: ref_templates.render_template(source, params))
    assert got == want


RESOLVE = {
    "stored": {"id": "s1", "params": {"q": "w3"}},
    "stored_object_source": {"id": "obj"},
    "inline": {"source": '{"size": {{n}}}', "params": {"n": 4}},
    "missing_stored": {"id": "nope"},
    "no_source_or_id": {"params": {}},
    "invalid_json": {"source": '{"size": {{n}}', "params": {"n": 1}},
}


@pytest.mark.parametrize("case", sorted(RESOLVE))
def test_resolve_template_cases_match_reference(case):
    got = _outcome(lambda: templates.resolve_template(_Store, RESOLVE[case]))
    want = _outcome(lambda: ref_templates.resolve_template(_Store, RESOLVE[case]))
    if case == "invalid_json":  # json's message carries the same position
        assert got[:3] == want[:3] == ("error", 400, "illegal_argument_exception")
    assert got == want


def test_search_templates(tmp_path):
    """The reference's tests/test_runtime_querystring.py::test_search_templates
    through both apps."""
    nd = "".join(json.dumps({"index": {"_index": "t", "_id": str(i)}}) + "\n"
                 + json.dumps({"name": f"item {i}", "n": i}) + "\n" for i in range(5))
    seq = [
        ("put", "PUT", "/t", {"mappings": {"properties": {
            "name": {"type": "text"}, "n": {"type": "integer"}}}}, {}),
        ("bulk", "POST", "/_bulk", nd, {}),
        ("refresh", "POST", "/t/_refresh", None, {}),
        ("inline", "POST", "/t/_search/template", {
            "source": '{"query": {"range": {"n": {"gte": {{min_n}}{{^min_n}}0{{/min_n}}}}},'
                      ' "size": {{size}}}',
            "params": {"min_n": 3, "size": 10}}, {}),
        ("store", "PUT", "/_scripts/my-tpl", {"script": {
            "lang": "mustache", "source": '{"query": {"match": {"name": "{{q}}"}}}'}}, {}),
        ("stored", "POST", "/t/_search/template", {"id": "my-tpl", "params": {"q": "item 2"}},
         {}),
        ("render", "POST", "/_render/template", {
            "source": '{"query": {"terms": {"n": {{#toJson}}ns{{/toJson}}}}}',
            "params": {"ns": [1, 2]}}, {}),
        ("get", "GET", "/_scripts/my-tpl", None, {}),
        ("delete", "DELETE", "/_scripts/my-tpl", None, {}),
        ("get_gone", "GET", "/_scripts/my-tpl", None, {}),
    ]
    port, ref = rest_both(seq, tmp_path)
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in ref.items()}
    assert port["inline"][1]["hits"]["total"]["value"] == 2
    assert port["stored"][1]["hits"]["total"]["value"] >= 1
    for name in ("inline", "stored"):
        same_hits(port[name][1], ref[name][1], name)
    assert port["render"][1]["template_output"] == {"query": {"terms": {"n": [1, 2]}}}
    for name in ("store", "render", "get", "delete", "get_gone"):
        assert port[name] == ref[name], name
    assert port["get_gone"][0] == 404


def test_stored_script_routes_match_reference(tmp_path):
    seq = [
        ("put", "PUT", "/_scripts/a", {"script": {"source": {"query": {"match_all": {}}}}}, {}),
        ("post", "POST", "/_scripts/b", {"script": {"lang": "mustache",
                                                     "source": '{"size": {{n}}}'}}, {}),
        ("get_a", "GET", "/_scripts/a", None, {}),
        ("get_b", "GET", "/_scripts/b", None, {}),
        ("no_source", "PUT", "/_scripts/c", {"script": {"lang": "mustache"}}, {}),
        ("no_script", "PUT", "/_scripts/c", {}, {}),
        ("get_missing", "GET", "/_scripts/c", None, {}),
        ("delete_missing", "DELETE", "/_scripts/c", None, {}),
        ("render_id", "POST", "/_render/template/b", {"params": {"n": 5}}, {}),
        ("render_missing", "POST", "/_render/template/zz", {}, {}),
        ("render_no_source", "POST", "/_render/template", {"params": {}}, {}),
        ("overwrite", "PUT", "/_scripts/b", {"script": {"source": '{"size": 1}'}}, {}),
        ("get_b2", "GET", "/_scripts/b", None, {}),
        ("delete_a", "DELETE", "/_scripts/a", None, {}),
    ]
    port, ref = rest_both(seq, tmp_path)
    assert port == ref
    assert port["no_source"][0] == 400 and port["get_missing"] == (
        404, {"_id": "c", "found": False})
    assert port["delete_missing"][1]["error"]["type"] == "resource_not_found_exception"


def _bulk(docs, index: str) -> str:
    return "".join(json.dumps({"index": {"_index": index, "_id": i}}) + "\n" + json.dumps(d)
                   + "\n" for i, d in docs)


TEMPLATE = ('{"query": {"match": {"body": "{{q}}"}}, "size": {{size}}'
            '{{^nofrom}}, "from": {{from}}{{/nofrom}}}')
RANGE_TEMPLATE = ('{"query": {"bool": {"must": [{"match": {"body": "{{q}}"}}], "filter": '
                  '[{"range": {"n": {"gte": {{lo}}, "lt": {{hi}}}}}]}}, '
                  '"sort": {{#toJson}}sort{{/toJson}}, "size": {{size}}}')
AGG_TEMPLATE = ('{"query": {"match": {"body": "{{q}}"}}, "size": 3, "aggs": {"t": '
                '{"terms": {"field": "tag", "size": {{k}}}}}, "highlight": {"fields": '
                '{"body": {}}}}')


def _template_bodies(rng) -> list:
    out = []
    for j in range(8):
        q = " ".join(f"w{int(x)}" for x in rng.integers(0, 40, 2))
        if j % 4 == 0:
            out.append({"id": "by-q", "params": {"q": q, "size": int(rng.integers(1, 12)),
                                                 "from": int(rng.integers(0, 5))}})
        elif j % 4 == 1:
            lo = int(rng.integers(0, 40))
            out.append({"source": RANGE_TEMPLATE, "params": {
                "q": q, "lo": lo, "hi": lo + 10, "size": 7,
                "sort": [{"n": "desc"}, {"tag": {"order": "asc", "missing": "_first"}}]}})
        elif j % 4 == 2:
            out.append({"source": AGG_TEMPLATE, "params": {"q": q, "k": 4}})
        else:
            out.append({"id": "by-q", "params": {"q": q, "size": 5, "nofrom": True}})
    return out


def _seq(shards: int, tiered: bool, seed: int) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    docs = text_docs(seed, 150)
    seq = [("create", "PUT", "/tp", {"settings": {"number_of_shards": shards},
                                     "mappings": MAPPING}, {}),
           ("bulk", "POST", "/_bulk", _bulk(docs, "tp"), {"refresh": "true"}),
           ("store", "PUT", "/_scripts/by-q", {"script": {"lang": "mustache",
                                                           "source": TEMPLATE}}, {})]
    if tiered:
        more = text_docs(seed + 1, 40)
        more = [(i if k % 2 else f"{i}-n", d) for k, (i, d) in enumerate(more)]
        seq.append(("bulk2", "POST", "/_bulk", _bulk(more, "tp"), {}))
        for i in sorted({int(x) for x in rng.integers(40, 150, 10)}):
            seq.append((f"del{i}", "DELETE", f"/tp/_doc/d{i}", None, {}))
        seq.append(("refresh2", "POST", "/tp/_refresh", None, {}))
    checked = []
    store = type("Store", (), {"stored_scripts": {"by-q": {"source": TEMPLATE}}})
    for j, body in enumerate(_template_bodies(rng)):
        seq.append((f"t{j}", "POST", "/tp/_search/template", body, {}))
        # the rendered body's plain `_search`, on the same tiers
        seq.append((f"p{j}", "POST", "/tp/_search", templates.resolve_template(store, body)[1],
                    {}))
        seq.append((f"r{j}", "POST", "/_render/template", body, {}))
        checked.append(j)
    lines = []
    for j, body in enumerate(_template_bodies(rng)[:5]):
        lines += [json.dumps({"index": "tp"}), json.dumps(body)]
    lines += [json.dumps({}), json.dumps({"id": "missing"})]
    lines += [json.dumps({"index": "nope"}), json.dumps({"source": '{"size": 1}'})]
    seq.append(("msearch", "POST", "/_msearch/template", "\n".join(lines) + "\n", {}))
    seq.append(("msearch_idx", "POST", "/tp/_msearch/template",
                "\n".join(lines[:4]) + "\n", {}))
    return seq, checked


def _strip(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k != "took"}


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_templated_searches_match_reference_and_plain_search(tmp_path, shards, tiered):
    seq, checked = _seq(shards, tiered, seed=shards + 5 * tiered)
    app = make_app(device="cpu")
    try:
        port, ref = rest_both(seq, tmp_path, port_app=app)
        if tiered:  # the writes took an incremental refresh (a search merges them later)
            kinds = app.engine.refresh_recorder.indexing_stats()["refresh_kinds"]
            assert kinds.get("incremental", 0) >= 1, kinds
        for name in port:
            assert port[name][0] == ref[name][0], (name, port[name], ref[name])
        for j in checked:
            (st, got), (_s, want) = port[f"t{j}"], ref[f"t{j}"]
            assert st == 200, got
            same_hits(got, want, f"t{j}")
            assert [h.get("highlight") for h in got["hits"]["hits"]] == \
                [h.get("highlight") for h in want["hits"]["hits"]]
            assert port[f"r{j}"] == ref[f"r{j}"]
            assert port[f"p{j}"][0] == 200 and _strip(port[f"p{j}"][1]) == _strip(got), j
        for name in ("msearch", "msearch_idx"):
            g, w = port[name][1]["responses"], ref[name][1]["responses"]
            assert [r["status"] for r in g] == [r["status"] for r in w]
            for a, b in zip(g, w):
                if a["status"] == 200:
                    same_hits(a, b, name)
                else:
                    assert a["error"] == b["error"]
        assert [r["status"] for r in port["msearch"][1]["responses"]][-2:] == [404, 404]
    finally:
        app.close()


def test_stored_scripts_are_kept_in_memory_only(tmp_path):
    """Queue C: the reference saves its stored scripts with its metadata
    (`cluster/metadata.py`), so an engine restarted on the same data path
    finds them; the port's `Engine.stored_scripts` lives in memory, so a new
    engine starts without them."""
    put = [("put", "PUT", "/_scripts/keep", {"script": {"source": '{"size": 1}'}}, {})]
    get = [("get", "GET", "/_scripts/keep", None, {})]
    rest_both(put, tmp_path)
    port, ref = rest_both(get, tmp_path)
    assert ref["get"][0] == 200 and ref["get"][1]["found"] is True
    assert port["get"] == (404, {"_id": "keep", "found": False})
