"""Dimension specs + extraction functions — Druid JSON mirror.

`DimensionSpec` (default, extraction) and the extraction functions
(timeFormat, javascript, regex, substring, ...).  An extraction is a host-side
*dictionary rewrite*: the function runs once over the (small) dictionary,
producing a code -> new-code remap table that the device applies per row with
one gather; there is never per-row string work on the device.

Time-granularity bucketing (`GROUP BY date_trunc(...)`) is the exception: it
is arithmetic on the int64 time column, done on the device
(`exec/lowering.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


class ExtractionFn:
    def to_druid(self) -> Dict[str, Any]:
        raise NotImplementedError

    def apply_to_dict(self, values):
        """Map each dictionary value -> extracted string (host-side)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class RegexExtraction(ExtractionFn):
    pattern: str
    index: int = 1
    replace_missing: Optional[str] = None

    def to_druid(self):
        return {"type": "regex", "expr": self.pattern}

    def apply_to_dict(self, values):
        import re

        rx = re.compile(self.pattern)
        out = []
        for v in values:
            m = rx.search(v)
            out.append(m.group(self.index) if m else (self.replace_missing or v))
        return out


@dataclasses.dataclass(frozen=True)
class SubstringExtraction(ExtractionFn):
    index: int
    length: Optional[int] = None

    def to_druid(self):
        d = {"type": "substring", "index": self.index}
        if self.length is not None:
            d["length"] = self.length
        return d

    def apply_to_dict(self, values):
        if self.length is None:
            return [v[self.index:] for v in values]
        return [v[self.index : self.index + self.length] for v in values]


@dataclasses.dataclass(frozen=True)
class CaseExtraction(ExtractionFn):
    """UPPER/LOWER over a dimension — a pure dictionary rewrite."""

    upper: bool

    def to_druid(self):
        return {"type": "upper" if self.upper else "lower"}

    def apply_to_dict(self, values):
        return [v.upper() if self.upper else v.lower() for v in values]


@dataclasses.dataclass(frozen=True)
class CascadeExtraction(ExtractionFn):
    """Druid `cascade` — composed extractions applied left-to-right
    (innermost string function first)."""

    fns: tuple  # Tuple[ExtractionFn, ...]

    def to_druid(self):
        return {
            "type": "cascade",
            "extractionFns": [f.to_druid() for f in self.fns],
        }

    def apply_to_dict(self, values):
        for f in self.fns:
            values = f.apply_to_dict(values)
        return values


def _js_str(s: str) -> str:
    """Escape a Python string into a single-quoted JS string literal body:
    backslash FIRST, then quote and control characters — a lone backslash
    must not escape the closing quote of the generated function."""
    return (
        s.replace("\\", "\\\\")
        .replace("'", "\\'")
        .replace("\n", "\\n")
        .replace("\r", "\\r")
        .replace("\t", "\\t")
    )


@dataclasses.dataclass(frozen=True)
class StrFuncExtraction(ExtractionFn):
    """TRIM/LTRIM/RTRIM/REPLACE over a dimension — pure dictionary
    rewrites with no native Druid extraction type.  Serialized as Druid's
    `javascript` extraction."""

    fn: str
    args: tuple = ()

    def to_druid(self):
        if self.fn == "replace":
            f, t = _js_str(str(self.args[0])), _js_str(str(self.args[1]))
            body = f"x.split('{f}').join('{t}')"
        else:
            # SQL TRIM strips spaces only; JS trim() strips all whitespace
            pat = {
                "trim": "/^ +| +$/g", "ltrim": "/^ +/", "rtrim": "/ +$/"
            }[self.fn]
            body = f"x.replace({pat},'')"
        return {
            "type": "javascript",
            "function": f"function(x){{return x==null?null:{body}}}",
        }

    def apply_to_dict(self, values):
        from ..plan.expr import apply_strfunc

        return [apply_strfunc(self.fn, self.args, v) for v in values]


@dataclasses.dataclass(frozen=True)
class TimeFormatExtraction(ExtractionFn):
    """Druid `timeFormat` — used when grouping the time column by a calendar
    granularity that isn't a fixed millisecond period (month/quarter/year)."""

    format: str  # strftime-style
    granularity: Optional[str] = None

    def to_druid(self):
        d = {"type": "timeFormat", "format": self.format}
        if self.granularity:
            d["granularity"] = self.granularity
        return d

    def apply_to_dict(self, values):  # applied to time bucket starts, host-side
        import datetime

        return [
            datetime.datetime.fromtimestamp(int(v) / 1000.0, tz=datetime.timezone.utc)
            .strftime(self.format)
            for v in values
        ]


@dataclasses.dataclass(frozen=True)
class TimeFieldExtraction(ExtractionFn):
    """SQL EXTRACT(field FROM ts) as a dimension.

    Dictionary-backed: over a numeric-dict date dimension the field is
    computed per DICTIONARY VALUE (host-side, O(cardinality)); over the time
    column the engine buckets at the field's granularity and remaps bucket
    starts — either way the kernel sees one int32 gather.  Values decode as
    ints (SQL EXTRACT returns numbers), unlike the string-valued Druid
    timeFormat this wire-serializes to."""

    field: str  # year | month | day | hour | minute | second

    _FORMATS = {
        "year": "%Y", "month": "%m", "day": "%d",
        "hour": "%H", "minute": "%M", "second": "%S",
    }

    def to_druid(self):
        return {"type": "timeFormat", "format": self._FORMATS[self.field]}

    @property
    def granularity(self) -> str:
        """Bucket granularity that makes the field constant per bucket."""
        return self.field

    def apply_to_dict(self, values):
        import datetime

        out = []
        for v in values:
            ms = int(v)
            dt = datetime.datetime.fromtimestamp(
                ms / 1000.0, tz=datetime.timezone.utc
            )
            out.append(
                {
                    "year": dt.year,
                    "month": dt.month,
                    "day": dt.day,
                    "hour": dt.hour,
                    "minute": dt.minute,
                    "second": dt.second,
                }[self.field]
            )
        return out


@dataclasses.dataclass(frozen=True)
class DimensionSpec:
    """Output dimension of a GroupBy/TopN: a physical dimension (or __time),
    an optional extraction fn, and the output name."""

    dimension: str
    output_name: Optional[str] = None
    extraction: Optional[ExtractionFn] = None
    # time-dimension bucketing (when dimension == "__time")
    granularity: Optional[str] = None  # e.g. "hour", "day", "month", "P3M"

    @property
    def name(self) -> str:
        return self.output_name or self.dimension

    def to_druid(self):
        if self.extraction is None:
            return {
                "type": "default",
                "dimension": self.dimension,
                "outputName": self.name,
            }
        return {
            "type": "extraction",
            "dimension": self.dimension,
            "outputName": self.name,
            "extractionFn": self.extraction.to_druid(),
        }


@dataclasses.dataclass(frozen=True)
class LookupExtraction(ExtractionFn):
    """Druid `lookup` extraction: map dimension values through a registered
    key->value table at query time (`LOOKUP(dim, 'name')` in SQL).  The map
    travels as a tuple of pairs so the spec stays frozen/hashable; semantics
    follow Druid's map lookup: unmapped values become `replace_missing`
    (None -> null group, the Druid default) unless `retain_missing`, which
    passes them through unchanged."""

    name: str
    mapping: Tuple[Tuple[str, str], ...]
    retain_missing: bool = False
    replace_missing: Optional[str] = None

    @classmethod
    def from_mapping(
        cls,
        name: str,
        mapping,
        retain_missing: bool = False,
        replace_missing: Optional[str] = None,
    ) -> "LookupExtraction":
        """Canonical constructor from a dict-like mapping: the sorted-pairs
        normalization lives HERE so every construction path (SQL planning,
        wire decode) produces specs that hash/compare equal for the same
        logical lookup."""
        return cls(
            name,
            tuple(sorted((str(k), str(v)) for k, v in dict(mapping).items())),
            retain_missing=retain_missing,
            replace_missing=replace_missing,
        )

    def to_druid(self):
        d: Dict[str, Any] = {
            "type": "lookup",
            # `name` is not part of Druid's inline-map wire form, but losing
            # it on a round-trip would make the decoded spec hash differently
            # from the locally planned one (cache miss); our decoder reads it
            # back and Druid-side consumers ignore unknown fields
            "name": self.name,
            "lookup": {"type": "map", "map": dict(self.mapping)},
        }
        if self.retain_missing:
            d["retainMissingValue"] = True
        elif self.replace_missing is not None:
            d["replaceMissingValueWith"] = self.replace_missing
        return d

    def apply_to_dict(self, values):
        m = dict(self.mapping)
        if self.retain_missing:
            return [m.get(v, v) for v in values]
        # Druid: without retain/replace, unmapped values become null (None
        # here folds into the dimension's null group)
        return [m.get(v, self.replace_missing) for v in values]


@dataclasses.dataclass(frozen=True)
class FormatExtraction(ExtractionFn):
    """CONCAT with one dimension operand: literal prefix/suffix around the
    value — Druid's `stringFormat` extraction; a pure dictionary rewrite."""

    prefix: str = ""
    suffix: str = ""

    def to_druid(self):
        # literal '%' must be escaped for Java's String.format
        pre = self.prefix.replace("%", "%%")
        suf = self.suffix.replace("%", "%%")
        return {"type": "stringFormat", "format": f"{pre}%s{suf}"}

    def apply_to_dict(self, values):
        from ..plan.expr import apply_strfunc

        return [
            apply_strfunc("concat", (self.prefix, self.suffix), v)
            for v in values
        ]


@dataclasses.dataclass(frozen=True)
class StrlenExtraction(ExtractionFn):
    """LENGTH over a dimension (Druid `strlen`), as integer lengths."""

    def to_druid(self):
        return {"type": "strlen"}

    def apply_to_dict(self, values):
        from ..plan.expr import apply_strfunc

        return [apply_strfunc("length", (), v) for v in values]
