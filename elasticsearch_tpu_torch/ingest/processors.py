"""Ingest processors: the part ES|QL's DISSECT and GROK pipes run.

A copy of the JAX package's `ingest/processors.py` (reference behavior:
ingest/Processor SPI and modules/ingest-common/.../DissectProcessor.java,
GrokProcessor.java), cut to the field access of the `Processor` base and
the dissect and grok processors. Each processor transforms a ctx dict (the
document source); dotted field paths address nested objects, as in the
reference's IngestDocument. The other processors, the pipelines and their
`if` conditions are not ported yet.
"""

from __future__ import annotations

import re
from typing import Any

from ..utils.errors import IllegalArgumentError


class IngestProcessorError(Exception):
    def __init__(self, message: str, processor_type: str):
        super().__init__(message)
        self.processor_type = processor_type


# -- field path helpers ----------------------------------------------------


def _split_path(path: str) -> list[str]:
    if not path:
        raise IllegalArgumentError("field path cannot be empty")
    return path.split(".")


def get_field(ctx: dict, path: str, default=None):
    cur: Any = ctx
    for p in _split_path(path):
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        else:
            return default
    return cur


def set_field(ctx: dict, path: str, value):
    parts = _split_path(path)
    cur = ctx
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value


# -- the processors --------------------------------------------------------


class Processor:
    """The base's config and field access (the reference's `if`,
    `ignore_failure` and `on_failure` belong to pipelines, not ported)."""

    type: str = "?"

    def __init__(self, config: dict):
        self.config = config

    def process(self, ctx: dict) -> None:
        raise NotImplementedError

    def _fail(self, msg: str):
        raise IngestProcessorError(msg, self.type)

    def _field(self, key="field") -> str:
        v = self.config.get(key)
        if not v:
            self._fail(f"[{key}] required property is missing")
        return v


class DissectProcessor(Processor):
    """%{key} pattern splitter (libs/dissect DissectParser)."""

    type = "dissect"

    def process(self, ctx):
        field = self._field()
        pattern = self.config.get("pattern")
        if pattern is None:
            self._fail("[pattern] required property is missing")
        val = get_field(ctx, field)
        if val is None:
            if self.config.get("ignore_missing", False):
                return
            self._fail(f"field [{field}] is null or missing")
        sep = self.config.get("append_separator", "")
        keys = re.findall(r"%\{([^}]*)\}", pattern)
        rx_parts = re.split(r"%\{[^}]*\}", pattern)
        rx = "".join(
            re.escape(p) + ("(.*?)" if i < len(keys) else "")
            for i, p in enumerate(rx_parts)
        ) + "$"
        m = re.match(rx, str(val), re.DOTALL)
        if m is None:
            self._fail(f"Unable to find match for dissect pattern: {pattern} "
                       f"against source: {val}")
        appends: dict[str, list] = {}
        for key, g in zip(keys, m.groups()):
            if not key or key.startswith("?"):
                continue
            if key.startswith("+"):
                appends.setdefault(key[1:], []).append(g)
            else:
                set_field(ctx, key, g)
        for key, parts in appends.items():
            base = get_field(ctx, key)
            all_parts = ([base] if base is not None else []) + parts
            set_field(ctx, key, sep.join(str(p) for p in all_parts))


_GROK_PATTERNS = {
    "WORD": r"\w+",
    "NOTSPACE": r"\S+",
    "SPACE": r"\s*",
    "DATA": r".*?",
    "GREEDYDATA": r".*",
    "INT": r"[+-]?\d+",
    "NUMBER": r"[+-]?\d+(?:\.\d+)?",
    "BASE10NUM": r"[+-]?\d+(?:\.\d+)?",
    "POSINT": r"\d+",
    "IP": r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}",
    "IPORHOST": r"[\w.\-:]+",
    "HOSTNAME": r"[\w.\-]+",
    "USER": r"[\w.\-]+",
    "USERNAME": r"[\w.\-]+",
    "EMAILADDRESS": r"[\w.+\-]+@[\w.\-]+",
    "UUID": r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}",
    "TIMESTAMP_ISO8601": r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:?\d{2})?",
    "LOGLEVEL": r"(?:TRACE|DEBUG|INFO|NOTICE|WARN(?:ING)?|ERROR|SEVERE|CRIT(?:ICAL)?|FATAL)",
    "HTTPDATE": r"\d{2}/\w{3}/\d{4}:\d{2}:\d{2}:\d{2} [+-]\d{4}",
    "QS": r"\"[^\"]*\"",
    "QUOTEDSTRING": r"\"[^\"]*\"",
    "URIPATH": r"/[^\s?#]*",
    "URIPARAM": r"\?[^\s#]*",
}


class GrokProcessor(Processor):
    """Grok with the core built-in pattern set (the reference bundles the full
    pattern bank in libs/grok; this is the commonly-used subset)."""

    type = "grok"

    def __init__(self, config):
        super().__init__(config)
        self.patterns = config.get("patterns") or []
        if not self.patterns:
            self._fail("[patterns] required property is missing")
        bank = dict(_GROK_PATTERNS)
        bank.update(config.get("pattern_definitions") or {})
        self.compiled = []
        for p in self.patterns:
            self.compiled.append(re.compile(self._to_regex(p, bank)))

    def _to_regex(self, pattern: str, bank: dict, depth=0) -> str:
        if depth > 10:
            self._fail("circular grok pattern reference")

        def sub(m):
            name = m.group(1)
            field = m.group(3)
            typ = m.group(5)
            body = bank.get(name)
            if body is None:
                self._fail(f"Unable to find pattern [{name}]")
            body = self._to_regex(body, bank, depth + 1)
            if field:
                safe = field.replace(".", "__DOT__").replace("@", "__AT__")
                return f"(?P<{safe}>{body})"
            return f"(?:{body})"

        return re.sub(r"%\{(\w+)(:([\w.@]+)(:(int|long|float|double))?)?\}", sub, pattern)

    def process(self, ctx):
        field = self._field()
        val = get_field(ctx, field)
        if val is None:
            if self.config.get("ignore_missing", False):
                return
            self._fail(f"field [{field}] is null or missing")
        for pat_src, rx in zip(self.patterns, self.compiled):
            m = rx.search(str(val))
            if m is None:
                continue
            types = dict(re.findall(r"%\{\w+:([\w.@]+):(int|long|float|double)\}", pat_src))
            for k, v in m.groupdict().items():
                if v is None:
                    continue
                k = k.replace("__DOT__", ".").replace("__AT__", "@")
                t = types.get(k)
                if t in ("int", "long"):
                    v = int(v)
                elif t in ("float", "double"):
                    v = float(v)
                set_field(ctx, k, v)
            return
        self._fail(f"Provided Grok expressions do not match field value: [{val}]")
