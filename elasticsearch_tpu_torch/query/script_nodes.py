"""Script-driven scoring queries: script_score, function_score, script filter.

The counterpart of the JAX package's `query/script_nodes.py` (reference
behavior: index/query/functionscore/FunctionScoreQueryBuilder.java,
ScriptScoreQueryBuilder.java, ScriptQueryBuilder.java; the functions of
common/lucene/search/function/*). A compiled expression
(`script/expression.py`) evaluates eagerly over the shard's docvalues
columns on their device, so a "per-doc script" is a few elementwise passes;
the node yields (scores, match) like every other node, and the searcher's
top k goes through `top_k_with_total` (the `scan_topk` kernel on the card).
Every constant is an f32 0-dim tensor or a Python float of an f32 value,
as the jnp program's f32 scalars are.

`random_score` reproduces the reference's per-doc values: a 32-bit
multiplicative hash of the shard-local docid and the seed, in int64
arithmetic cut to 32 bits after each step, over 2^32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..script.expression import CompiledScript, ScriptError, compile_script
from ..utils.errors import IllegalArgumentError, QueryParsingError
from .nodes import ExecContext, MatchAllNode, QueryNode, mark_exact

_U32 = 0xFFFFFFFF


def _f32(v) -> float:
    """A Python float holding v rounded to f32 (torch multiplies an f32
    tensor by it in f32, as by the reference's jnp.float32 scalar)."""
    return float(np.float32(v))


def _column(dev: dict, f: str):
    """(values, has) of a numeric docvalues column, or None."""
    for key in ("dv_float", "dv_int"):
        if f in dev[key]:
            return dev[key][f]
    return None


def script_env(dev: dict, fields, ctx: ExecContext):
    """{field: f32 [n]} docvalues env of a compiled script; a missing value
    reads as 0 (lang-expression semantics)."""
    env = {}
    n = ctx.num_docs
    for f in fields:
        col = _column(dev, f)
        if col is None:
            raise ScriptError(f"field [{f}] has no numeric doc values for scripting")
        vals, has = col
        env[f] = torch.where(has, vals.to(torch.float32), 0.0)[:n]
    return env


def _padded(vals: torch.Tensor, n: int, match: torch.Tensor) -> torch.Tensor:
    """[n] (or a 0-dim constant) -> [n+1] scores, 0 off the match set."""
    out = torch.zeros(n + 1, dtype=torch.float32, device=match.device)
    out[:n] = vals
    return torch.where(match, out, 0.0)


@dataclass
class ScriptScoreNode(QueryNode):
    """script_score: the script's value replaces the inner query's score
    (ScriptScoreQueryBuilder; a negative value is an error in the
    reference, clamped at 0 here as in the JAX package)."""

    inner: QueryNode
    script: CompiledScript
    min_score: float | None = None
    boost: float = 1.0

    def prepare(self, pack):
        return self.inner.prepare(pack)

    def device_eval(self, dev, params, ctx):
        scores, match = self.inner.device_eval(dev, params, ctx)
        n = ctx.num_docs
        env = script_env(dev, self.script.fields, ctx)
        val = self.script.evaluate(env, score=scores[:n]).to(torch.float32)
        val = torch.maximum(val, torch.zeros((), device=val.device)) * _f32(self.boost)
        out = _padded(val, n, match)
        if self.min_score is not None:
            match = match & (out >= self.min_score)
        return out, match


@dataclass
class ScriptFilterNode(QueryNode):
    """The `script` query: filter context, matching where the expression is
    not 0 (ScriptQueryBuilder); constant score = boost."""

    script: CompiledScript
    boost: float = 1.0

    def prepare(self, pack):
        return None

    def device_eval(self, dev, params, ctx):
        n = ctx.num_docs
        env = script_env(dev, self.script.fields, ctx)
        ok = self.script.evaluate(env, score=None) != 0
        if not isinstance(ok, torch.Tensor):  # a script with no field and no score
            ok = torch.tensor(bool(ok), device=ctx.device)
        match = torch.zeros(n + 1, dtype=torch.bool, device=ctx.device)
        match[:n] = ok
        return _f32(self.boost) * match.to(torch.float32), match


# ---------------------------------------------------------------------------
# function_score
# ---------------------------------------------------------------------------

_MODIFIERS = {
    "none": lambda x: x,
    "log": torch.log10,
    "log1p": lambda x: torch.log10(x + 1.0),
    "log2p": lambda x: torch.log10(x + 2.0),
    "ln": torch.log,
    "ln1p": torch.log1p,
    "ln2p": lambda x: torch.log(x + 2.0),
    "square": torch.square,
    "sqrt": torch.sqrt,
    "reciprocal": lambda x: 1.0 / x,
}


def random_score_values(n: int, seed: int, device) -> torch.Tensor:
    """[n] f32 in [0, 1): the reference's hash of (shard-local docid, seed)
    (uint32 multiply-xorshift), each 32-bit product formed from 16-bit
    halves so no int64 product overflows."""
    def mul32(h, c):
        lo = h * (c & 0xFFFF)
        hi = ((h * (c >> 16)) & 0xFFFF) << 16
        return (lo + hi) & _U32

    h = torch.arange(n, dtype=torch.int64, device=device) ^ ((seed * 2654435761) & _U32)
    h = mul32(h, 2246822519)
    h = mul32(h ^ (h >> 13), 3266489917)
    h = h ^ (h >> 16)
    return h.to(torch.float32) / float(2 ** 32)


@dataclass
class ScoreFunction:
    kind: str  # weight | field_value_factor | script_score | random_score | decay
    filter: QueryNode | None = None
    weight: float | None = None
    # field_value_factor
    fvf_field: str | None = None
    fvf_factor: float = 1.0
    fvf_modifier: str = "none"
    fvf_missing: float | None = None
    # script_score
    script: CompiledScript | None = None
    # random_score
    seed: int = 0
    # decay
    decay_kind: str = "gauss"  # gauss | exp | linear
    decay_field: str | None = None
    origin: float = 0.0
    scale: float = 1.0
    offset: float = 0.0
    decay: float = 0.5

    def value(self, dev, ctx: ExecContext, scores_n):
        n = ctx.num_docs
        device = ctx.device
        if self.kind == "weight":
            v = torch.ones(n, dtype=torch.float32, device=device)
        elif self.kind == "field_value_factor":
            col = _column(dev, self.fvf_field)
            if col is None:
                raise IllegalArgumentError(
                    f"unable to find a field mapper for field [{self.fvf_field}]")
            vals, has = col
            x = vals.to(torch.float32)[:n]
            if self.fvf_missing is not None:
                x = torch.where(has[:n], x, torch.tensor(np.float32(self.fvf_missing),
                                                         device=device))
            # the reference errors on a missing value without `missing`; here
            # it scores as its modifier of 0 (the JAX package's divergence)
            v = _MODIFIERS[self.fvf_modifier](x * _f32(self.fvf_factor))
            v = torch.where(torch.isfinite(v), v, 0.0)
        elif self.kind == "script_score":
            env = script_env(dev, self.script.fields, ctx)
            v = torch.broadcast_to(self.script.evaluate(env, score=scores_n).to(torch.float32),
                                   (n,))
        elif self.kind == "random_score":
            v = random_score_values(n, self.seed, device)
        elif self.kind == "decay":
            col = _column(dev, self.decay_field)
            if col is None:
                raise IllegalArgumentError(f"unknown decay field [{self.decay_field}]")
            vals, has = col
            f32 = lambda c: torch.tensor(np.float32(c), device=device)  # noqa: E731
            x = vals.to(torch.float32)[:n]
            dist = torch.clamp_min(torch.abs(x - f32(self.origin)) - f32(self.offset), 0.0)
            scale, decay = f32(self.scale), f32(self.decay)
            if self.decay_kind == "gauss":
                sigma2 = -(scale ** 2) / (2.0 * torch.log(decay))
                v = torch.exp(-(dist ** 2) / (2.0 * sigma2))
            elif self.decay_kind == "exp":
                v = torch.exp(torch.log(decay) / scale * dist)
            else:  # linear
                s = scale / (1.0 - decay)
                v = torch.clamp_min((s - dist) / s, 0.0)
            v = torch.where(has[:n], v, 1.0)
        else:
            raise IllegalArgumentError(f"unknown score function [{self.kind}]")
        if self.weight is not None:
            v = v * _f32(self.weight)
        return v


@dataclass
class FunctionScoreNode(QueryNode):
    """function_score (FunctionScoreQueryBuilder): per-function filters,
    score_mode across the functions, boost_mode with the query score, the
    max_boost cap and the min_score cut."""

    inner: QueryNode
    functions: list[ScoreFunction] = field(default_factory=list)
    score_mode: str = "multiply"
    boost_mode: str = "multiply"
    max_boost: float = float("inf")
    min_score: float | None = None
    boost: float = 1.0

    def prepare(self, pack):
        return (self.inner.prepare(pack),
                [fn.filter.prepare(pack) if fn.filter is not None else None
                 for fn in self.functions])

    def _factor(self, dev, fparams, ctx, scores_n):
        """-> (factor [n], applied_any [n]) of the functions."""
        n = ctx.num_docs
        if not self.functions:
            return (torch.ones(n, dtype=torch.float32, device=ctx.device),
                    torch.zeros(n, dtype=torch.bool, device=ctx.device))
        applies, values = [], []
        for fn, fp in zip(self.functions, fparams):
            if fn.filter is not None:
                applies.append(fn.filter.device_eval(dev, fp, ctx)[1][:n])
            else:
                applies.append(torch.ones(n, dtype=torch.bool, device=ctx.device))
            values.append(fn.value(dev, ctx, scores_n))
        A = torch.stack(applies)  # [F, n]
        V = torch.stack(values)
        applied_any = A.any(dim=0)
        mode = self.score_mode
        if mode == "multiply":
            factor = torch.where(A, V, 1.0).prod(dim=0)
        elif mode == "sum":
            factor = torch.where(A, V, 0.0).sum(dim=0)
        elif mode == "avg":
            cnt = A.sum(dim=0, dtype=torch.int32)
            factor = torch.where(cnt > 0, torch.where(A, V, 0.0).sum(dim=0)
                                 / torch.clamp_min(cnt, 1), 1.0)
        elif mode == "max":
            factor = torch.where(A, V, float("-inf")).max(dim=0).values
        elif mode == "min":
            factor = torch.where(A, V, float("inf")).min(dim=0).values
        elif mode == "first":
            first = torch.argmax(A.to(torch.uint8), dim=0)
            factor = V.gather(0, first[None, :])[0]
        else:
            raise IllegalArgumentError(f"bad score_mode [{mode}]")
        return torch.where(applied_any, factor, 1.0), applied_any

    def device_eval(self, dev, params, ctx):
        p, fparams = params
        scores, match = self.inner.device_eval(dev, p, ctx)
        n = ctx.num_docs
        scores_n = scores[:n]
        factor, applied_any = self._factor(dev, fparams, ctx, scores_n)
        factor = torch.minimum(factor, torch.tensor(np.float32(self.max_boost),
                                                    device=factor.device))
        bm = self.boost_mode
        if bm == "multiply":
            out_n = scores_n * factor
        elif bm == "replace":
            out_n = torch.where(applied_any | (len(self.functions) == 0), factor, scores_n)
        elif bm == "sum":
            out_n = scores_n + factor
        elif bm == "avg":
            out_n = (scores_n + factor) / 2.0
        elif bm == "max":
            out_n = torch.maximum(scores_n, factor)
        elif bm == "min":
            out_n = torch.minimum(scores_n, factor)
        else:
            raise IllegalArgumentError(f"bad boost_mode [{bm}]")
        out = _padded(out_n * _f32(self.boost), n, match)
        if self.min_score is not None:
            match = match & (out >= self.min_score)
        return out, match


# ---------------------------------------------------------------------------
# DSL parsing (registered in dsl.py)
# ---------------------------------------------------------------------------


def parse_script_score(body: dict, mappings, parse_query):
    if "query" not in body:
        raise QueryParsingError("[script_score] requires a [query]")
    # the script reads the child's _score: exact BM25, off the impact tier
    inner = mark_exact(parse_query(body["query"], mappings))
    return ScriptScoreNode(inner, compile_script(body.get("script") or {}),
                           min_score=body.get("min_score"),
                           boost=float(body.get("boost", 1.0)))


def parse_script_filter(body: dict, mappings, parse_query):
    return ScriptFilterNode(compile_script(body.get("script") or {}),
                            boost=float(body.get("boost", 1.0)))


def _decay_value(v, is_date: bool, default=None):
    from ..index.mappings import parse_date_to_millis
    from ..utils.durations import parse_duration_seconds

    if v is None:
        return default
    if is_date and isinstance(v, str):
        try:  # durations like "10d" (scale, offset)
            return float(parse_duration_seconds(v, None) * 1000.0)
        except Exception:  # noqa: BLE001 - not a duration: a date
            return float(parse_date_to_millis(v))
    return float(v)


def _parse_one_function(spec: dict, mappings, parse_query) -> ScoreFunction:
    filt = parse_query(spec["filter"], mappings) if "filter" in spec else None
    weight = spec.get("weight")
    kinds = [k for k in spec if k not in ("filter", "weight")]
    if not kinds:
        return ScoreFunction("weight", filter=filt,
                             weight=float(weight if weight is not None else 1.0))
    if len(kinds) > 1:
        raise QueryParsingError(f"more than one function in clause: {kinds}")
    kind = kinds[0]
    body = spec[kind]
    w = float(weight) if weight is not None else None
    if kind == "field_value_factor":
        return ScoreFunction("field_value_factor", filter=filt, weight=w,
                             fvf_field=body["field"], fvf_factor=float(body.get("factor", 1.0)),
                             fvf_modifier=body.get("modifier", "none"),
                             fvf_missing=body.get("missing"))
    if kind == "script_score":
        return ScoreFunction("script_score", filter=filt, weight=w,
                             script=compile_script(body.get("script") or {}))
    if kind == "random_score":
        return ScoreFunction("random_score", filter=filt, weight=w,
                             seed=int(body.get("seed", 0)))
    if kind in ("gauss", "exp", "linear"):
        (fld, conf), = [(k, v) for k, v in body.items() if k != "multi_value_mode"]
        ft = mappings.fields.get(fld)
        is_date = ft is not None and ft.type == "date"
        if "scale" not in conf:
            raise QueryParsingError(f"[{kind}] requires [scale]")
        return ScoreFunction("decay", filter=filt, weight=w, decay_kind=kind, decay_field=fld,
                             origin=_decay_value(conf.get("origin"), is_date, 0.0),
                             scale=_decay_value(conf["scale"], is_date),
                             offset=_decay_value(conf.get("offset"), is_date, 0.0),
                             decay=float(conf.get("decay", 0.5)))
    raise QueryParsingError(f"unknown score function [{kind}]")


_FUNCTION_KEYS = ("field_value_factor", "script_score", "random_score", "gauss", "exp",
                  "linear", "weight", "filter")


def parse_function_score(body: dict, mappings, parse_query):
    if body.get("query"):
        # boost_mode multiply, avg, ... transform the child's _score: exact
        # BM25, off the impact tier
        inner = mark_exact(parse_query(body["query"], mappings))
    else:
        inner = MatchAllNode()
    specs = body.get("functions")
    if specs is None:
        # the single-function shorthand at the top level
        specs = [{k: v for k, v in body.items() if k in _FUNCTION_KEYS}]
        if not any(k not in ("weight", "filter") for k in specs[0]) \
                and "weight" not in specs[0]:
            specs = []
    return FunctionScoreNode(
        inner, [_parse_one_function(s, mappings, parse_query) for s in specs],
        score_mode=body.get("score_mode", "multiply"),
        boost_mode=body.get("boost_mode", "multiply"),
        max_boost=float(body.get("max_boost", float("inf"))),
        min_score=body.get("min_score"),
        boost=float(body.get("boost", 1.0)))
