"""Index mappings: field types, dynamic mapping, document parsing.

Behavioral parity target: the reference mapper layer (reference:
server/.../index/mapper/MapperService.java, DocumentParser.java — JSON ->
typed fields; dynamic rules of DynamicFieldsBuilder), as the JAX package's
`index/mappings.py` implements it. Ported types and their columnar layout:

  text                    -> postings (blocked CSR) + norms; no docvalues
  keyword                 -> postings (single token) + ordinal docvalues
  long/integer/short/byte -> int64 docvalues
  double/float/half_float -> float32 docvalues
  date                    -> int64 epoch-millis docvalues
  boolean                 -> int64 {0, 1} docvalues
  dense_vector            -> [N, dims] float32 matrix (+ the IVF ANN index
                             when `index_options` asks for one)
  date_nanos              -> int64 epoch-nanos docvalues
  ip                      -> postings of the canonical address + ordinal
                             docvalues sorted by address (`ip_sort_key`)
  flattened               -> the keyword family: every leaf a term of the
                             root field and of a `root.path` keyword field
  rank_feature            -> float32 docvalues
  geo_point               -> float32 `field#lat` / `field#lon` columns
  percolator              -> the stored query objects, host side
  completion              -> (input, weight, docid) lists, host side, for
                             the completion suggester
  object, nested          -> their sub-fields (nested paths are recorded:
                             `nested` queries match per object)

Dynamic mapping maps JSON booleans to `boolean` and ISO-8601-looking
strings to `date`, as the reference does. Custom analyzers from the index
settings' `analysis` section resolve through `set_analysis` before the
built-ins.
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import re
from dataclasses import dataclass, field

from ..analysis import Analyzer, get_analyzer
from ..utils.errors import MapperParsingError

TEXT_TYPES = {"text"}
# flattened is the whole-object keyword family (reference behavior: x-pack
# FlattenedFieldMapper)
KEYWORD_TYPES = {"keyword", "flattened"}
IP_TYPES = {"ip"}
INT_TYPES = {"long", "integer", "short", "byte"}
FLOAT_TYPES = {"double", "float", "half_float", "rank_feature"}
DATE_TYPES = {"date"}
DATE_NANOS_TYPES = {"date_nanos"}
BOOL_TYPES = {"boolean"}
VECTOR_TYPES = {"dense_vector"}
GEO_TYPES = {"geo_point"}
COMPLETION_TYPES = {"completion"}
# values that keep their raw JSON shape through parsing (the pack reads them)
RAW_TYPES = {"geo_point", "percolator", "completion"}
ALL_TYPES = (TEXT_TYPES | KEYWORD_TYPES | IP_TYPES | INT_TYPES | FLOAT_TYPES | DATE_TYPES
             | DATE_NANOS_TYPES | BOOL_TYPES | VECTOR_TYPES | GEO_TYPES | COMPLETION_TYPES
             | {"object", "nested", "percolator"})
# dense_vector index_options types that ask for the ANN index (the JAX
# package's IVF partition index stands in for the reference's HNSW graphs)
ANN_INDEX_TYPES = ("hnsw", "int8_hnsw", "int4_hnsw", "ivf")

_INT_BOUNDS = {
    "long": (-(2**63), 2**63 - 1),
    "integer": (-(2**31), 2**31 - 1),
    "short": (-(2**15), 2**15 - 1),
    "byte": (-128, 127),
}

# strict_date_optional_time detection of the reference's dynamic mapping
_DATE_RE = re.compile(
    r"^\d{4}-\d{2}-\d{2}([T ]\d{2}:\d{2}(:\d{2}(\.\d+)?)?(Z|[+-]\d{2}:?\d{2})?)?$")


def parse_date_to_millis(value) -> int:
    """Parse the default `strict_date_optional_time||epoch_millis` to epoch
    ms (reference `index/mappings.py:parse_date_to_millis`)."""
    if isinstance(value, bool):
        raise MapperParsingError(f"failed to parse date [{value}]")
    if isinstance(value, (int, float)):
        return int(value)
    if isinstance(value, str):
        s = value.strip()
        # date_optional_time admits year and year-month prefixes; the
        # calendar readings come before epoch_millis, as ES's format list
        if re.fullmatch(r"\d{4}", s):
            return int(_dt.datetime(int(s), 1, 1, tzinfo=_dt.timezone.utc).timestamp() * 1000)
        if re.fullmatch(r"\d{4}-\d{2}", s):
            y, mo = s.split("-")
            return int(_dt.datetime(int(y), int(mo), 1,
                                    tzinfo=_dt.timezone.utc).timestamp() * 1000)
        try:
            s2 = s.replace("Z", "+00:00")
            if " " in s2 and "T" not in s2:
                s2 = s2.replace(" ", "T", 1)
            # no-colon utc offsets ("+0100" -> "+01:00")
            s2 = re.sub(r"([+-]\d{2})(\d{2})$", r"\1:\2", s2)
            dt = _dt.datetime.fromisoformat(s2)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return int(dt.timestamp() * 1000)
        except ValueError:
            pass
        if re.fullmatch(r"-?\d+", s):
            return int(s)
    raise MapperParsingError(f"failed to parse date value [{value}]")


# java DateTimeFormatter tokens -> strptime, longest first (MM = month, mm =
# minute); a pattern with another letter fails and the next
# ||-alternative is tried
_JAVA_TOKENS = [
    ("yyyy", "%Y"), ("uuuu", "%Y"), ("yy", "%y"),
    ("MM", "%m"), ("dd", "%d"), ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
    ("SSS", "%f"), ("epoch_millis", None), ("epoch_second", None),
]


def _java_to_strptime(pattern: str) -> str | None:
    out = []
    i = 0
    while i < len(pattern):
        for tok, py in _JAVA_TOKENS:
            if py and pattern.startswith(tok, i):
                out.append(py)
                i += len(tok)
                break
        else:
            c = pattern[i]
            if c.isalpha():
                return None
            out.append("%%" if c == "%" else c)
            i += 1
    return "".join(out)


def parse_date_with_formats(value, formats: str) -> int:
    """A date under the mapping's `format`: each ||-alternative in order
    (reference `index/mappings.py:parse_date_with_formats`)."""
    for fmt in formats.split("||"):
        fmt = fmt.strip()
        if fmt == "epoch_millis":
            try:
                return int(value)
            except (TypeError, ValueError):
                continue
        if fmt == "epoch_second":
            try:
                return int(value) * 1000
            except (TypeError, ValueError):
                continue
        if fmt in ("strict_date_optional_time", "date_optional_time",
                   "strict_date_optional_time_nanos", "basic_date_time",
                   "date_time", "strict_date_time"):
            try:
                return parse_date_to_millis(value)
            except MapperParsingError:
                continue
        py = _java_to_strptime(fmt)
        if py is None or not isinstance(value, str):
            continue
        try:
            dt = _dt.datetime.strptime(value, py)
            return int(dt.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000)
        except ValueError:
            continue
    raise MapperParsingError(f"failed to parse date value [{value}]")


def format_date_millis(ms: int, formats: str | None) -> str | int:
    """Epoch millis in the mapping's first format (reference
    `index/mappings.py:format_date_millis`)."""
    fmt = (formats or "strict_date_optional_time").split("||")[0].strip()
    if fmt == "epoch_millis":
        return int(ms)
    if fmt == "epoch_second":
        return int(ms) // 1000
    dt = _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)
    py = _java_to_strptime(fmt)
    if py is not None and "date_optional_time" not in fmt:
        out = dt.strftime(py)
        if "%f" in py:  # java SSS is milliseconds, strftime %f micros
            out = out.replace(dt.strftime("%f"), dt.strftime("%f")[:3])
        return out
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def parse_date_to_nanos(value) -> int:
    """date_nanos: epoch nanoseconds, keeping sub-millisecond digits
    (reference `index/mappings.py:parse_date_to_nanos`; behavior:
    DateFieldMapper.Resolution.NANOSECONDS). A number is epoch millis."""
    if isinstance(value, bool):
        raise MapperParsingError(f"failed to parse date [{value}]")
    if isinstance(value, (int, float)):
        return int(value) * 1_000_000
    if isinstance(value, str):
        s = value.strip()
        m = re.fullmatch(r"(.*[T ]\d{2}:\d{2}:\d{2})\.(\d{4,9})(Z|[+-]\d{2}:?\d{2})?", s)
        if m:
            base = m.group(1) + (m.group(3) or "")
            return parse_date_to_millis(base) * 1_000_000 + int(m.group(2).ljust(9, "0"))
        if re.fullmatch(r"-?\d+", s):
            return int(s) * 1_000_000
        return parse_date_to_millis(s) * 1_000_000
    raise MapperParsingError(f"failed to parse date value [{value}]")


def format_date_nanos(nanos: int) -> str:
    """Epoch nanos -> the nanosecond ISO form (strict_date_optional_time_nanos)."""
    secs, frac_ns = divmod(int(nanos), 1_000_000_000)
    dt = _dt.datetime.fromtimestamp(secs, tz=_dt.timezone.utc)
    frac = f"{frac_ns:09d}".rstrip("0") or "0"
    return dt.strftime("%Y-%m-%dT%H:%M:%S") + f".{frac}Z"


def ip_sort_key(s: str) -> bytes:
    """The total order of mixed v4 and v6 addresses: a v4 address compares
    as its v6-mapped form, so every v4 address sorts below the v6 ones past
    ::ffff:255.255.255.255 (reference behavior: a 16-byte InetAddressPoint)."""
    ip = ipaddress.ip_address(s)
    if ip.version == 4:  # the packed form of ::ffff:a.b.c.d
        return _V4_MAPPED + ip.packed
    return ip.packed


_V4_MAPPED = b"\x00" * 10 + b"\xff\xff"


def ip_keys(col) -> list:
    """The address keys (`ip_sort_key`) of an ip column's ordinal terms, in
    ordinal order, computed once per column and kept on it."""
    if col is None or not col.ord_terms:
        return []
    keys = getattr(col, "_ip_keys", None)
    if keys is None:
        keys = col._ip_keys = [ip_sort_key(t) for t in col.ord_terms]
    return keys


# the exact types of JSON's scalar values (a subclass is not one)
JSON_SCALARS = frozenset((str, int, float, bool, type(None)))


def _no_handler(ftype: str, fld: str) -> MapperParsingError:
    return MapperParsingError(f"no handler for type [{ftype}] declared on field [{fld}]")


@dataclass
class FieldType:
    name: str  # full dotted path
    type: str
    analyzer: str = "standard"
    search_analyzer: str | None = None
    index: bool = True
    doc_values: bool = True
    ignore_above: int | None = None  # keyword only
    dims: int | None = None  # dense_vector only
    similarity: str = "cosine"  # dense_vector: cosine|dot_product|l2_norm|max_inner_product
    # dense_vector ANN options: IVF partitions (None = no ANN index, 0 =
    # sqrt(N) at pack build) and the selection-scan tier (int8 | bf16)
    ann_nlist: int | None = None
    ann_quant: str = "int8"
    # date: the mapping's `format`, a ||-separated list of java patterns
    # and named formats (DateFieldMapper custom formats)
    format: str | None = None
    fields: dict = field(default_factory=dict)  # sub-fields (e.g. .keyword)
    index_options: dict | None = None  # dense_vector: as the mapping gave it
    _analyzer_obj: Analyzer | None = None
    # the index's custom analyzers (Mappings.set_analysis), looked up first
    _registry: dict | None = None
    # the memoized BatchedAnalyzer (analysis/batched.py), tied to the
    # analyzer object it was made for
    _batched_obj: object | None = None

    def to_dict(self) -> dict:
        """The mapping of this field as GET _mapping renders it (reference
        `index/mappings.py:FieldType.to_dict`)."""
        d: dict = {"type": self.type}
        if self.type in TEXT_TYPES and self.analyzer != "standard":
            d["analyzer"] = self.analyzer
        if self.type in VECTOR_TYPES:
            d["dims"] = self.dims
            d["similarity"] = self.similarity
            if self.index_options is not None:
                d["index_options"] = self.index_options
        if self.ignore_above is not None:
            d["ignore_above"] = self.ignore_above
        if self.fields:
            d["fields"] = {k: sub.to_dict() for k, sub in self.fields.items()}
        return d

    def get_analyzer(self) -> Analyzer:
        if self._analyzer_obj is None:
            reg = self._registry or {}
            self._analyzer_obj = reg.get(self.analyzer) or get_analyzer(self.analyzer)
        return self._analyzer_obj

    def get_batched_analyzer(self):
        """The batched counterpart of get_analyzer(), memoized; remade when
        the analyzer object is (reference `mappings.py:249-270`)."""
        from ..analysis.batched import BatchedAnalyzer

        an = self.get_analyzer()
        ba = self._batched_obj
        if ba is None or ba.analyzer is not an:
            ba = self._batched_obj = BatchedAnalyzer(an)
        return ba

    def get_search_analyzer(self) -> Analyzer:
        if self.search_analyzer:
            reg = self._registry or {}
            return reg.get(self.search_analyzer) or get_analyzer(self.search_analyzer)
        return self.get_analyzer()


class Mappings:
    """Field-type registry of one index; grows by dynamic mapping, never
    changes an existing field's type."""

    _TOP_LEVEL_KEYS = {"properties", "dynamic", "_source", "_meta"}

    def __init__(self, mapping_dict: dict | None = None, dynamic: str = "true",
                 analysis_registry: dict | None = None):
        self.fields: dict[str, FieldType] = {}
        self.dynamic = dynamic  # "true" | "false" | "strict"
        # nested object paths: their fields also index into the parent doc
        # (include_in_parent), and `nested` queries match per object
        # against the stored source
        self.nested_paths: set[str] = set()
        # the index's custom analyzers (settings `analysis`), and a
        # generation bumped by each `set_analysis` (a synonym reload)
        self.analysis_registry: dict[str, Analyzer] = analysis_registry or {}
        self.analysis_generation = 0
        if mapping_dict:
            if mapping_dict.keys() & self._TOP_LEVEL_KEYS:
                props = mapping_dict.get("properties", {})
            else:
                props = mapping_dict  # bare properties map shorthand
            self._parse_properties(props, prefix="")
            dyn = mapping_dict.get("dynamic", dynamic)
            self.dynamic = {True: "true", False: "false"}.get(dyn, str(dyn))

    def set_analysis(self, registry: dict[str, Analyzer]) -> None:
        """Attach the custom analyzers built from the index settings; every
        field resolves its analyzer names through them again (reference
        `Mappings.set_analysis`)."""
        self.analysis_generation += 1
        self.analysis_registry = registry or {}
        for ft in self.fields.values():
            ft._registry = self.analysis_registry
            ft._analyzer_obj = None
            ft._batched_obj = None

    def _parse_properties(self, props: dict, prefix: str):
        for name, spec in props.items():
            full = f"{prefix}{name}"
            if not isinstance(spec, dict):
                raise MapperParsingError(f"invalid mapping for field [{full}]")
            ftype = spec.get("type")
            if ftype is None and "properties" in spec or ftype in ("object", "nested"):
                if ftype == "nested":
                    self.nested_paths.add(full)
                self._parse_properties(spec.get("properties", {}), prefix=f"{full}.")
                continue
            if ftype not in ALL_TYPES:
                raise _no_handler(ftype, full)
            ft = FieldType(
                name=full,
                type=ftype,
                analyzer=spec.get("analyzer", "standard"),
                search_analyzer=spec.get("search_analyzer"),
                index=spec.get("index", True),
                doc_values=spec.get("doc_values", ftype not in TEXT_TYPES),
                ignore_above=spec.get("ignore_above"),
                dims=spec.get("dims"),
                similarity=spec.get("similarity", "cosine"),
                format=spec.get("format"),
            )
            ft._registry = self.analysis_registry
            if ftype in TEXT_TYPES:
                ft.get_analyzer()  # an unknown analyzer fails at mapping time
            if ftype in VECTOR_TYPES:
                self._vector_options(ft, spec)
            for sub_name, sub_spec in spec.get("fields", {}).items():
                stype = sub_spec.get("type", "keyword")
                sub = FieldType(
                    name=f"{full}.{sub_name}",
                    type=stype,
                    analyzer=sub_spec.get("analyzer", "standard"),
                    ignore_above=sub_spec.get("ignore_above"),
                )
                sub._registry = self.analysis_registry
                ft.fields[sub_name] = sub
                self.fields[sub.name] = sub
            self.fields[full] = ft

    @staticmethod
    def _vector_options(ft: FieldType, spec: dict) -> None:
        """dims is required; hnsw/int8_hnsw/int4_hnsw/ivf index_options
        ask for the ANN index (nlist 0 = auto), whose scan tier is the
        explicit `quantization`, else bf16 for hnsw and int8 for the rest
        (the JAX package's mapping of them)."""
        if not ft.dims:
            raise MapperParsingError(f"dense_vector field [{ft.name}] requires [dims]")
        io = spec.get("index_options") or {}
        ft.index_options = spec.get("index_options")
        if io.get("type") in ANN_INDEX_TYPES:
            ft.ann_nlist = int(io.get("nlist", 0))
            quant = io.get("quantization") or ("bf16" if io.get("type") == "hnsw" else "int8")
            if quant not in ("int8", "bf16"):
                raise MapperParsingError(
                    f"dense_vector [{ft.name}] index_options "
                    f"quantization must be int8|bf16, got [{quant}]")
            ft.ann_quant = quant

    def to_dict(self) -> dict:
        """{"properties": {...}} with sub-fields under their parent and
        dotted paths nested (reference `Mappings.to_dict`)."""
        props: dict = {}
        for name, ft in sorted(self.fields.items()):
            if "." in name:
                pft = self.fields.get(name.rsplit(".", 1)[0])
                if pft is not None and name.split(".")[-1] in pft.fields:
                    continue  # rendered as a sub-field of its parent
            node = props
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = ft.to_dict()
        return {"properties": props}

    # ---- dynamic mapping -------------------------------------------------

    def _dynamic_field(self, name: str, value) -> FieldType | None:
        if isinstance(value, bool):
            ft = FieldType(name, "boolean")
        elif isinstance(value, int):
            ft = FieldType(name, "long")
        elif isinstance(value, float):
            ft = FieldType(name, "float")
        elif isinstance(value, str):
            if _DATE_RE.match(value.strip()):
                ft = FieldType(name, "date")
            else:
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
        for fld, values in out.items():
            ft = self.fields.get(fld)
            if ft is not None and ft.type in VECTOR_TYPES and len(values) != ft.dims:
                raise MapperParsingError(
                    f"dense_vector [{fld}] has {len(values)} dims, mapping says {ft.dims}")
        return out

    def _parse_obj(self, obj: dict, prefix: str, out: dict):
        for key, value in obj.items():
            self._parse_value(f"{prefix}{key}", value, out)

    def _parse_value(self, full: str, value, out: dict):
        if value is None:
            return
        ft = self.fields.get(full)
        if ft is not None and ft.type in RAW_TYPES:
            # geo points, stored queries and completion inputs keep their
            # raw shape
            out.setdefault(full, []).append(value)
            return
        if isinstance(value, dict):
            if ft is not None and ft.type == "flattened":
                self._flatten_leaves(ft, full, "", value, out)
            else:
                self._parse_obj(value, f"{full}.", out)
            return
        if isinstance(value, list):
            if (ft is not None and ft.type in VECTOR_TYPES and not ft.fields
                    and all(isinstance(v, (int, float)) for v in value)):
                # a vector's components in one pass: the floats the
                # per-value path below gives them
                out.setdefault(full, []).extend(map(float, value))
                return
            if ft is not None and all(type(v) in JSON_SCALARS for v in value):
                # a mapped field's scalar values in one pass: what the
                # per-value path below gives each
                vals = out.setdefault(full, [])
                for v in value:
                    if v is not None:
                        vals.append(self._coerce(ft, v))
                        for sub in ft.fields.values():
                            out.setdefault(sub.name, []).append(self._coerce(sub, v))
                return
            for v in value:
                self._parse_value(full, v, out)
            return
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

    def _flatten_leaves(self, root: FieldType, full: str, sub: str, value, out: dict):
        """A flattened object's leaves index as keywords under the root field
        and under a dynamic `root.path` keyword field each (keyed access)."""
        if isinstance(value, dict):
            for k, v in value.items():
                self._flatten_leaves(root, full, f"{sub}.{k}" if sub else k, v, out)
            return
        if isinstance(value, list):
            for v in value:
                self._flatten_leaves(root, full, sub, v, out)
            return
        if value is None:
            return
        sval = ("true" if value else "false") if isinstance(value, bool) else str(value)
        out.setdefault(full, []).append(sval)
        if sub:
            key_field = f"{full}.{sub}"
            if key_field not in self.fields:
                self.fields[key_field] = FieldType(key_field, "keyword", index=root.index,
                                                   doc_values=root.doc_values)
            out.setdefault(key_field, []).append(sval)

    @staticmethod
    def _coerce(ft: FieldType, value):
        t = ft.type
        if t in TEXT_TYPES or t in KEYWORD_TYPES:
            if isinstance(value, bool):
                return "true" if value else "false"
            return str(value)
        if t in IP_TYPES:
            try:
                return str(ipaddress.ip_address(str(value)))
            except ValueError:
                raise MapperParsingError(
                    f"failed to parse field [{ft.name}] of type [ip]: "
                    f"'{value}' is not an IP string literal.")
        if t in DATE_NANOS_TYPES:
            return parse_date_to_nanos(value)
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
        if t in DATE_TYPES:
            if ft.format:
                return parse_date_with_formats(value, ft.format)
            return parse_date_to_millis(value)
        if t in BOOL_TYPES:
            if isinstance(value, bool):
                return value
            if value in ("true", "false"):
                return value == "true"
            raise MapperParsingError(f"failed to parse boolean field [{ft.name}]: [{value}]")
        if t in VECTOR_TYPES:
            # a vector flattens into its components, one value each; the
            # pack checks their count against dims
            if not isinstance(value, (int, float)):
                raise MapperParsingError(f"dense_vector [{ft.name}] expects numbers")
            return float(value)
        raise MapperParsingError(f"unsupported type [{t}]")
