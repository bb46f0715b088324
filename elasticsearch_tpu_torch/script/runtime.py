"""Runtime fields: request-scoped docvalues columns computed by a script.

The counterpart of the JAX package's `StackedSearcher.ensure_runtime_field`
/ `remove_runtime_fields` (`parallel/sharded.py:468-595`; reference
behavior: search-request runtime_mappings, mapper/RuntimeField.java). A
runtime field's script (the expression language; an `emit(expr)` source is
unwrapped) is evaluated once per distinct definition over the numeric
docvalues columns on the searcher's device, stored as a docvalues column
there (int64 for long, date and boolean, f32 for double), and mirrored to
the host for planning (bucket counts, sort keys, terms-agg ordinals), so
queries, aggs and sort see it as a mapped column. A doc has a value when
every field the script reads has one. The columns of the last 16
definitions stay cached on the searcher, so a repeated request installs
without recomputing; `remove` uninstalls them after the request.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

from ..index.mappings import FieldType
from ..index.pack import DocValuesColumn
from ..utils.errors import IllegalArgumentError
from .expression import CompiledScript, compile_script

# runtime type -> its docvalues kind (the mapping type is the runtime type)
RUNTIME_TYPES = {"long": "int", "date": "int", "boolean": "int", "double": "float"}
CACHE_SIZE = 16


def compile_runtime(script) -> CompiledScript:
    src = script.get("source") if isinstance(script, dict) else script
    params = (script.get("params") if isinstance(script, dict) else None) or {}
    s = (src or "").strip()
    if s.startswith("emit(") and s.endswith(")"):
        s = s[5:-1]
    return compile_script({"source": s, "params": params})


def runtime_values(compiled: CompiledScript, kind: str, col_of, n: int, device):
    """One shard's column: compiled over the numeric columns `col_of(f)`
    gives ((values, has) tensors, or None) -> (values [n], has [n]) on
    `device`; a field without numeric docvalues reads 0 and leaves no doc
    with a value."""
    env = {}
    has = torch.ones(n, dtype=torch.bool, device=device)
    for f in compiled.fields:
        col = col_of(f)
        if col is None:
            env[f] = torch.zeros(n, dtype=torch.float32, device=device)
            has = torch.zeros_like(has)
        else:
            v, h = col
            env[f] = torch.where(h[:n], v[:n], 0).to(torch.float32)
            has = has & h[:n]
    out = torch.as_tensor(compiled.evaluate(env), device=device)
    out = torch.broadcast_to(out, (n,))
    return out.to(torch.int64 if kind == "int" else torch.float32), has


def host_column(kind: str, vals: np.ndarray, has: np.ndarray) -> DocValuesColumn:
    """The planning mirror of a runtime column (any leading shape): min and
    max over the present values, and for an int column its sorted unique
    values and per-doc ordinals (-1 where missing)."""
    col = DocValuesColumn(kind, vals, has)
    present = vals[has]
    if present.size:
        col.vmin = present.min().item()
        col.vmax = present.max().item()
        if kind == "int":
            uniq = np.unique(present)
            col.uniq_values = uniq
            ords = np.full(vals.shape, -1, np.int32)
            ords[has] = np.searchsorted(uniq, vals[has]).astype(np.int32)
            col.uniq_ords = ords
    return col


class RuntimeFieldHost:
    """The runtime-field API of a searcher (`ShardSearcher`,
    `StackedSearcher`; reference `parallel/sharded.py:468`, `:580`), which
    provides `_runtime_build`, `_runtime_install`, `_runtime_uninstall`,
    `_runtime_mapped` and the `runtime_mappings` property."""

    _runtime = None  # RuntimeFields, made at first use

    def ensure_runtime_field(self, name: str, rtype: str, script) -> None:
        """Install a request's runtime field as a docvalues column on the
        device."""
        if self._runtime is None:
            self._runtime = RuntimeFields(self)
        self._runtime.ensure(name, rtype, script)

    def remove_runtime_fields(self, names) -> None:
        """Uninstall a request's runtime fields."""
        if self._runtime is not None:
            self._runtime.remove(names)


class RuntimeFields:
    """The runtime fields installed on one searcher (a RuntimeFieldHost):
    `_runtime_build(compiled, kind)` -> artifacts, `_runtime_install(name,
    artifacts)`, `_runtime_uninstall(name)`, `_runtime_mapped(name)` and the
    `runtime_mappings` property (its mappings, read and set)."""

    def __init__(self, searcher):
        self.searcher = searcher
        self.installed: dict[str, tuple] = {}  # name -> definition key
        self.types: dict[str, str] = {}  # name -> runtime type
        self.cache: dict[tuple, dict] = {}  # definition key -> artifacts
        self.base_mappings = None

    def ensure(self, name: str, rtype: str, script) -> None:
        src = script.get("source") if isinstance(script, dict) else script
        params = (script.get("params") if isinstance(script, dict) else None) or {}
        # params are baked into the compiled expression: part of the key
        key = (name, rtype, src, json.dumps(params, sort_keys=True))
        if self.installed.get(name) == key:
            return
        s = self.searcher
        if s._runtime_mapped(name) and name not in self.installed:
            raise IllegalArgumentError(f"runtime field [{name}] shadows a mapped field")
        if rtype not in RUNTIME_TYPES:
            raise IllegalArgumentError(
                f"runtime field type [{rtype}] is not supported (numeric only)")
        art = self.cache.get(key)
        if art is None:
            art = s._runtime_build(compile_runtime(script), RUNTIME_TYPES[rtype])
            if len(self.cache) >= CACHE_SIZE:  # bound the memory of one-off scripts
                self.cache.pop(next(iter(self.cache)))
            self.cache[key] = art
        s._runtime_install(name, art)
        self.installed[name] = key
        self.types[name] = rtype
        self._overlay()

    def remove(self, names) -> None:
        for name in names:
            if self.installed.pop(name, None) is None:
                continue
            self.types.pop(name, None)
            self.searcher._runtime_uninstall(name)
        self._overlay()

    def _overlay(self) -> None:
        """The searcher's mappings: its own plus a field per runtime field."""
        s = self.searcher
        if self.base_mappings is None:
            self.base_mappings = s.runtime_mappings
        base = self.base_mappings
        if base is None:
            return
        if not self.types:
            s.runtime_mappings = base
            return
        m = copy.copy(base)
        m.fields = {**base.fields, **{nm: FieldType(name=nm, type=t, index=False)
                                      for nm, t in self.types.items()}}
        s.runtime_mappings = m
