"""Scripting: the expression language, evaluated as array programs.

This package's copy of the JAX package's `script/expression.py`, which
compiles the reference's expression-language subset (arithmetic over
values, `_score`, params, math builtins, ternaries; reference:
modules/lang-expression and the painless arithmetic subset) to array
programs. `evaluate` runs on torch tensors when the env or the score holds
one (the scripted queries of `query/script_nodes.py` and the runtime
fields, eagerly on the tensors' device, every constant an f32 0-dim tensor
there) and with numpy otherwise (the pipeline aggs `bucket_script` and
`bucket_selector`, `script_fields` and the update scripts on the host), in
f32 as the reference's jnp program.

Grammar (JS-like, matching lang-expression + the painless arithmetic subset):
    expr    := ternary
    ternary := or ('?' ternary ':' ternary)?
    or      := and ('||' and)*
    and     := cmp ('&&' cmp)*
    cmp     := add (('=='|'!='|'<'|'<='|'>'|'>=') add)?
    add     := mul (('+'|'-') mul)*
    mul     := unary (('*'|'/'|'%') unary)*
    unary   := ('-'|'!') unary | postfix
    postfix := primary ('.' ident | '(' args ')' | '[' str ']')*
    primary := number | str | ident | '(' expr ')'

Field access: `doc['f'].value`, `doc.f.value`, or a bare `f`.
`_score` is the query score; `params.x` are compile-time constants.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.errors import IllegalArgumentError


class ScriptError(IllegalArgumentError):
    pass


_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<str>'[^']*'|\"[^\"]*\")"
    r"|(?P<op>\|\||&&|==|!=|<=|>=|\*\*|[-+*/%^()\[\].,?:<>!]))"
)


def _tokenize(src: str):
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise ScriptError(f"unexpected character [{src[pos]}] at {pos}")
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", float(m.group("num"))))
        elif m.group("name") is not None:
            out.append(("name", m.group("name")))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1]))
        else:
            out.append(("op", m.group("op")))
    out.append(("eof", None))
    return out


# AST: ("num", v) ("field", name) ("score",) ("param", name)
#      ("un", op, a) ("bin", op, a, b) ("cmp", op, a, b) ("bool", op, a, b)
#      ("tern", c, a, b) ("call", fname, [args])

_FUNCS_1 = {
    "abs": np.abs, "sqrt": np.sqrt, "exp": np.exp, "ln": np.log,
    "log": np.log, "log10": np.log10, "log2": np.log2,
    "floor": np.floor, "ceil": np.ceil, "round": np.round,
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "signum": np.sign,
}
_FUNCS_2 = {
    "min": np.minimum, "max": np.maximum,
    "pow": np.power, "atan2": np.arctan2, "hypot": np.hypot,
}


_TORCH_FUNCS_1 = {
    "abs": torch.abs, "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
    "log": torch.log, "log10": torch.log10, "log2": torch.log2,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "signum": torch.sign,
}
_TORCH_FUNCS_2 = {
    "min": torch.minimum, "max": torch.maximum,
    "pow": torch.pow, "atan2": torch.atan2, "hypot": torch.hypot,
}


class _NumpyOps:
    """The array functions of a host evaluation."""

    funcs1, funcs2 = _FUNCS_1, _FUNCS_2
    where, mod, power = staticmethod(np.where), staticmethod(np.mod), staticmethod(np.power)

    @staticmethod
    def const(v):
        return np.float32(v)

    @staticmethod
    def f32(x):
        return x.astype(np.float32)


class _TorchOps:
    """The array functions of an evaluation on tensors of one device."""

    funcs1, funcs2 = _TORCH_FUNCS_1, _TORCH_FUNCS_2
    mod, power = staticmethod(torch.remainder), staticmethod(torch.pow)

    def __init__(self, device):
        self.device = device

    def const(self, v):
        return torch.tensor(np.float32(v), device=self.device)

    @staticmethod
    def f32(x):
        return x.to(torch.float32)

    def where(self, c, a, b):
        as_t = (lambda x: x if isinstance(x, torch.Tensor)
                else torch.tensor(np.float32(x), device=self.device))
        return torch.where(c, as_t(a), as_t(b))


def _ops_for(env: dict, score):
    """torch functions when the env or the score holds a tensor, else numpy."""
    for v in (score, *env.values()):
        if isinstance(v, torch.Tensor):
            return _TorchOps(v.device)
    return _NumpyOps


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op):
        t = self.next()
        if t != ("op", op):
            raise ScriptError(f"expected [{op}], got {t}")

    def parse(self):
        e = self.ternary()
        if self.peek()[0] != "eof":
            raise ScriptError(f"trailing tokens at {self.peek()}")
        return e

    def ternary(self):
        c = self.or_()
        if self.peek() == ("op", "?"):
            self.next()
            a = self.ternary()
            self.expect_op(":")
            b = self.ternary()
            return ("tern", c, a, b)
        return c

    def or_(self):
        a = self.and_()
        while self.peek() == ("op", "||"):
            self.next()
            a = ("bool", "or", a, self.and_())
        return a

    def and_(self):
        a = self.cmp()
        while self.peek() == ("op", "&&"):
            self.next()
            a = ("bool", "and", a, self.cmp())
        return a

    def cmp(self):
        a = self.add()
        t = self.peek()
        if t[0] == "op" and t[1] in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            return ("cmp", t[1], a, self.add())
        return a

    def add(self):
        a = self.mul()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            a = ("bin", op, a, self.mul())
        return a

    def mul(self):
        a = self.unary()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%", "^", "**"):
            op = self.next()[1]
            a = ("bin", op, a, self.unary())
        return a

    def unary(self):
        t = self.peek()
        if t == ("op", "-"):
            self.next()
            return ("un", "-", self.unary())
        if t == ("op", "!"):
            self.next()
            return ("un", "!", self.unary())
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while True:
            t = self.peek()
            if t == ("op", "."):
                self.next()
                name = self.next()
                if name[0] != "name":
                    raise ScriptError(f"expected name after '.', got {name}")
                e = ("attr", e, name[1])
            elif t == ("op", "["):
                self.next()
                key = self.next()
                if key[0] != "str":
                    raise ScriptError("only string keys allowed in [...]")
                self.expect_op("]")
                e = ("index", e, key[1])
            elif t == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.ternary())
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.ternary())
                self.expect_op(")")
                e = ("call", e, args)
            else:
                return e

    def primary(self):
        t = self.next()
        if t[0] == "num":
            return ("num", t[1])
        if t[0] == "str":
            return ("strlit", t[1])
        if t[0] == "name":
            return ("name", t[1])
        if t == ("op", "("):
            e = self.ternary()
            self.expect_op(")")
            return e
        raise ScriptError(f"unexpected token {t}")


def _resolve(ast, fields: set, params: dict):
    """Rewrite name/attr/index chains into field/param/score refs."""
    kind = ast[0]
    if kind == "num":
        return ast
    if kind == "strlit":
        raise ScriptError("string values are not usable in arithmetic scripts")
    if kind == "name":
        name = ast[1]
        if name == "_score":
            return ("score",)
        if name in ("doc", "params", "Math"):
            raise ScriptError(f"[{name}] must be followed by an access")
        fields.add(name)
        return ("field", name)
    if kind == "index":
        base, key = ast[1], ast[2]
        if base == ("name", "doc"):
            fields.add(key)
            return ("field", key)
        raise ScriptError("only doc['field'] indexing is supported")
    if kind == "attr":
        base, name = ast[1], ast[2]
        if base == ("name", "params"):
            if name not in params:
                raise ScriptError(f"missing script param [{name}]")
            return ("num", float(params[name]))
        if base == ("name", "Math"):
            return ("mathfn", name)
        if base == ("name", "doc"):
            fields.add(name)
            return ("field", name)
        # doc['f'].value / .length etc -> the field ref itself
        inner = _resolve(base, fields, params)
        if inner[0] == "field" and name in ("value", "length", "size"):
            return inner
        raise ScriptError(f"unsupported attribute [.{name}]")
    if kind == "call":
        fn, args = ast[1], ast[2]
        args = [_resolve(a, fields, params) for a in args]
        fn = _resolve(fn, fields, params) if fn[0] != "name" else fn
        if fn[0] == "mathfn" or fn[0] == "name":
            return ("callfn", fn[1], args)
        raise ScriptError("cannot call a non-function")
    if kind in ("un",):
        return (kind, ast[1], _resolve(ast[2], fields, params))
    if kind in ("bin", "cmp", "bool"):
        return (kind, ast[1], _resolve(ast[2], fields, params),
                _resolve(ast[3], fields, params))
    if kind == "tern":
        return (kind, _resolve(ast[1], fields, params),
                _resolve(ast[2], fields, params), _resolve(ast[3], fields, params))
    raise ScriptError(f"unsupported syntax {kind}")


def _eval(ast, env: dict, score, ops):
    kind = ast[0]
    if kind == "num":
        return ops.const(ast[1])
    if kind == "score":
        if score is None:
            raise ScriptError("_score is not available in this context")
        return score
    if kind == "field":
        if ast[1] not in env:
            raise ScriptError(f"unknown field [{ast[1]}] in script")
        return env[ast[1]]
    if kind == "un":
        v = _eval(ast[2], env, score, ops)
        return -v if ast[1] == "-" else ops.f32(ops.where(v != 0, 0.0, 1.0))
    if kind == "bin":
        a = _eval(ast[2], env, score, ops)
        b = _eval(ast[3], env, score, ops)
        op = ast[1]
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "%":
            return ops.mod(a, b)
        return ops.power(a, b)  # ^ / **
    if kind == "cmp":
        a = _eval(ast[2], env, score, ops)
        b = _eval(ast[3], env, score, ops)
        op = ast[1]
        r = {
            "==": a == b, "!=": a != b, "<": a < b,
            "<=": a <= b, ">": a > b, ">=": a >= b,
        }[op]
        return ops.f32(r)
    if kind == "bool":
        a = _eval(ast[2], env, score, ops)
        b = _eval(ast[3], env, score, ops)
        if ast[1] == "or":
            return ops.f32((a != 0) | (b != 0))
        return ops.f32((a != 0) & (b != 0))
    if kind == "tern":
        c = _eval(ast[1], env, score, ops)
        a = _eval(ast[2], env, score, ops)
        b = _eval(ast[3], env, score, ops)
        return ops.where(c != 0, a, b)
    if kind == "callfn":
        name, args = ast[1], ast[2]
        vals = [_eval(a, env, score, ops) for a in args]
        if name in ops.funcs1 and len(vals) == 1:
            return ops.funcs1[name](vals[0])
        if name in ops.funcs2 and len(vals) == 2:
            return ops.funcs2[name](vals[0], vals[1])
        if name == "saturation" and len(vals) == 2:
            return vals[0] / (vals[0] + vals[1])
        if name == "sigmoid" and len(vals) == 3:
            x, k, a = vals
            return ops.power(x, a) / (ops.power(k, a) + ops.power(x, a))
        if name == "randomScore":
            raise ScriptError("use the random_score function_score function")
        raise ScriptError(f"unknown function [{name}] with {len(vals)} args")
    raise ScriptError(f"cannot evaluate {kind}")


@dataclass
class CompiledScript:
    """A script compiled to a vectorized array program.

    `fields` are the doc-value fields it reads. `evaluate(env, score)` maps
    {field: array} (+ an optional score array) -> array: torch tensors on
    their device, or numpy arrays on the host."""

    source: str
    ast: tuple
    fields: frozenset = field(default_factory=frozenset)

    def evaluate(self, env: dict, score=None):
        return _eval(self.ast, env, score, _ops_for(env, score))


def compile_script(script: str | dict) -> CompiledScript:
    """Accepts the DSL's script forms: "src", {"source": ..., "params": {...}},
    {"inline"/"id": ...} (ids unsupported — no stored-scripts store yet)."""
    params = {}
    if isinstance(script, dict):
        params = script.get("params") or {}
        src = script.get("source") or script.get("inline")
        if src is None:
            raise ScriptError("script requires [source]")
    else:
        src = script
    if not isinstance(src, str):
        raise ScriptError("script source must be a string")
    fields: set = set()
    ast = _Parser(_tokenize(src)).parse()
    ast = _resolve(ast, fields, params)
    return CompiledScript(src, ast, frozenset(fields))
