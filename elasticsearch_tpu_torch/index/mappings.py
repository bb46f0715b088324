"""Index mappings: field types, dynamic mapping, document parsing.

Behavioral parity target: the reference mapper layer (reference:
server/.../index/mapper/MapperService.java, DocumentParser.java — JSON ->
typed fields; dynamic rules of DynamicFieldsBuilder), as the JAX package's
`index/mappings.py` implements it. Ported types and their columnar layout:

  text                    -> postings (blocked CSR) + norms; no docvalues
  keyword                 -> postings (single token) + ordinal docvalues
  long/integer/short/byte -> int64 docvalues
  double/float/half_float -> float32 docvalues

Any other type raises "not yet ported" — at mapping time for explicit
mappings, at parse time for dynamically detected ones (booleans and
ISO-8601-looking strings, which the reference maps to `boolean`/`date`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ..analysis import StandardAnalyzer, get_analyzer
from ..utils.errors import MapperParsingError

TEXT_TYPES = {"text"}
KEYWORD_TYPES = {"keyword"}
INT_TYPES = {"long", "integer", "short", "byte"}
FLOAT_TYPES = {"double", "float", "half_float"}
PORTED_TYPES = TEXT_TYPES | KEYWORD_TYPES | INT_TYPES | FLOAT_TYPES

_INT_BOUNDS = {
    "long": (-(2**63), 2**63 - 1),
    "integer": (-(2**31), 2**31 - 1),
    "short": (-(2**15), 2**15 - 1),
    "byte": (-128, 127),
}

# strict_date_optional_time detection of the reference's dynamic mapping
_DATE_RE = re.compile(
    r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?)?$")


def _not_ported(ftype: str, fld: str) -> MapperParsingError:
    return MapperParsingError(
        f"field type [{ftype}] of field [{fld}] is not yet ported")


@dataclass
class FieldType:
    name: str  # full dotted path
    type: str
    analyzer: str = "standard"
    search_analyzer: str | None = None
    index: bool = True
    doc_values: bool = True
    ignore_above: int | None = None  # keyword only
    fields: dict = field(default_factory=dict)  # sub-fields (e.g. .keyword)
    _analyzer_obj: StandardAnalyzer | None = None

    def get_analyzer(self) -> StandardAnalyzer:
        if self._analyzer_obj is None:
            self._analyzer_obj = get_analyzer(self.analyzer)
        return self._analyzer_obj

    def get_search_analyzer(self) -> StandardAnalyzer:
        if self.search_analyzer:
            return get_analyzer(self.search_analyzer)
        return self.get_analyzer()


class Mappings:
    """Field-type registry of one index; grows by dynamic mapping, never
    changes an existing field's type."""

    _TOP_LEVEL_KEYS = {"properties", "dynamic", "_source", "_meta"}

    def __init__(self, mapping_dict: dict | None = None, dynamic: str = "true"):
        self.fields: dict[str, FieldType] = {}
        self.dynamic = dynamic  # "true" | "false" | "strict"
        if mapping_dict:
            if mapping_dict.keys() & self._TOP_LEVEL_KEYS:
                props = mapping_dict.get("properties", {})
            else:
                props = mapping_dict  # bare properties map shorthand
            self._parse_properties(props, prefix="")
            dyn = mapping_dict.get("dynamic", dynamic)
            self.dynamic = {True: "true", False: "false"}.get(dyn, str(dyn))

    def _parse_properties(self, props: dict, prefix: str):
        for name, spec in props.items():
            full = f"{prefix}{name}"
            if not isinstance(spec, dict):
                raise MapperParsingError(f"invalid mapping for field [{full}]")
            ftype = spec.get("type")
            if ftype is None and "properties" in spec or ftype == "object":
                self._parse_properties(spec.get("properties", {}), prefix=f"{full}.")
                continue
            if ftype not in PORTED_TYPES:
                raise _not_ported(ftype, full)
            ft = FieldType(
                name=full,
                type=ftype,
                analyzer=spec.get("analyzer", "standard"),
                search_analyzer=spec.get("search_analyzer"),
                index=spec.get("index", True),
                doc_values=spec.get("doc_values", ftype not in TEXT_TYPES),
                ignore_above=spec.get("ignore_above"),
            )
            if ftype in TEXT_TYPES:
                ft.get_analyzer()  # an unported analyzer fails at mapping time
            for sub_name, sub_spec in spec.get("fields", {}).items():
                stype = sub_spec.get("type", "keyword")
                if stype not in PORTED_TYPES:
                    raise _not_ported(stype, f"{full}.{sub_name}")
                sub = FieldType(
                    name=f"{full}.{sub_name}",
                    type=stype,
                    analyzer=sub_spec.get("analyzer", "standard"),
                    ignore_above=sub_spec.get("ignore_above"),
                )
                ft.fields[sub_name] = sub
                self.fields[sub.name] = sub
            self.fields[full] = ft

    # ---- dynamic mapping -------------------------------------------------

    def _dynamic_field(self, name: str, value) -> FieldType | None:
        if isinstance(value, bool):
            raise _not_ported("boolean", name)
        if isinstance(value, int):
            ft = FieldType(name, "long")
        elif isinstance(value, float):
            ft = FieldType(name, "float")
        elif isinstance(value, str):
            if _DATE_RE.match(value.strip()):
                raise _not_ported("date", name)
            ft = FieldType(name, "text")
            kw = FieldType(f"{name}.keyword", "keyword", ignore_above=256)
            ft.fields["keyword"] = kw
            self.fields[kw.name] = kw
        else:
            return None
        self.fields[name] = ft
        return ft

    # ---- document parsing ------------------------------------------------

    def parse_document(self, source: dict) -> dict[str, list]:
        """Flatten a JSON document into {field_path: [values]}, adding
        dynamic mappings as needed. Arrays flatten into multiple values of
        the same field (an array is just a multi-valued field)."""
        out: dict[str, list] = {}
        self._parse_obj(source, "", out)
        return out

    def _parse_obj(self, obj: dict, prefix: str, out: dict):
        for key, value in obj.items():
            self._parse_value(f"{prefix}{key}", value, out)

    def _parse_value(self, full: str, value, out: dict):
        if value is None:
            return
        if isinstance(value, dict):
            self._parse_obj(value, f"{full}.", out)
            return
        if isinstance(value, list):
            for v in value:
                self._parse_value(full, v, out)
            return
        ft = self.fields.get(full)
        if ft is None:
            if self.dynamic == "strict":
                raise MapperParsingError(
                    f"mapping set to strict, dynamic introduction of [{full}] is not allowed"
                )
            if self.dynamic == "false":
                return
            ft = self._dynamic_field(full, value)
            if ft is None:
                return
        out.setdefault(full, []).append(self._coerce(ft, value))
        for sub in ft.fields.values():
            out.setdefault(sub.name, []).append(self._coerce(sub, value))

    @staticmethod
    def _coerce(ft: FieldType, value):
        t = ft.type
        if t in TEXT_TYPES or t in KEYWORD_TYPES:
            if isinstance(value, bool):
                return "true" if value else "false"
            return str(value)
        if t in INT_TYPES:
            try:
                iv = int(value)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse field [{ft.name}] of type [{t}]: [{value}]")
            lo, hi = _INT_BOUNDS[t]
            if not (lo <= iv <= hi):
                raise MapperParsingError(f"value [{value}] out of range for type [{t}]")
            return iv
        if t in FLOAT_TYPES:
            try:
                return float(value)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse field [{ft.name}] of type [{t}]: [{value}]")
        raise _not_ported(t, ft.name)
