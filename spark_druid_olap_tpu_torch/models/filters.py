"""Filter spec family — mirror of Druid's filter JSON sub-language.

The spec tree is plain data; `ops/filters.py` compiles it into a function
from segment columns (torch tensors) to a boolean row mask, the way Druid
evaluates a filter inside its historical engine.  `ExpressionFilter` carries a
residual scalar predicate (`plan/expr.py`).  `filter_from_druid` decodes
Druid's filter JSON back into the tree (the wire front end, `models/wire.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


class Filter:
    """Base class.  `to_druid()` produces wire-compatible Druid JSON."""

    def to_druid(self) -> Dict[str, Any]:
        raise NotImplementedError

    # sugar for building trees
    def __and__(self, other: "Filter") -> "Filter":
        return And(tuple(f for f in (self, other)))

    def __or__(self, other: "Filter") -> "Filter":
        return Or(tuple(f for f in (self, other)))

    def __invert__(self) -> "Filter":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class Selector(Filter):
    """dimension == value (Druid `selector`)."""

    dimension: str
    value: Optional[str]

    def to_druid(self):
        return {"type": "selector", "dimension": self.dimension, "value": self.value}


@dataclasses.dataclass(frozen=True)
class InFilter(Filter):
    """dimension IN (values) (Druid `in`).

    `null_in_values` records that the ORIGINAL list contained a literal
    NULL (stripped from `values`): a positive match set is unchanged, but
    under Kleene evaluation every NON-member row is then UNKNOWN rather
    than FALSE — which is what makes `NOT (x IN (..., NULL))` match
    nothing at any negation depth (SQL three-valued semantics)."""

    dimension: str
    values: Tuple[str, ...]
    null_in_values: bool = False

    def to_druid(self):
        vals = list(self.values)
        if self.null_in_values:
            vals = vals + [None]
        return {"type": "in", "dimension": self.dimension, "values": vals}


@dataclasses.dataclass(frozen=True)
class Bound(Filter):
    """Range filter (Druid `bound`).  `ordering` is "lexicographic" for string
    dimensions (sound because our dictionaries are sorted — codes preserve
    order) or "numeric" for metric/time columns."""

    dimension: str
    lower: Optional[str] = None
    upper: Optional[str] = None
    lower_strict: bool = False
    upper_strict: bool = False
    ordering: str = "lexicographic"

    def to_druid(self):
        d: Dict[str, Any] = {"type": "bound", "dimension": self.dimension}
        if self.lower is not None:
            d["lower"] = self.lower
            d["lowerStrict"] = self.lower_strict
        if self.upper is not None:
            d["upper"] = self.upper
            d["upperStrict"] = self.upper_strict
        d["ordering"] = self.ordering
        return d


@dataclasses.dataclass(frozen=True)
class Regex(Filter):
    """Druid `regex` filter.  Evaluated host-side against the dictionary (the
    dictionary is small; match once per dict entry, then it's an `in` filter on
    codes — strictly better than Druid's per-row regex)."""

    dimension: str
    pattern: str

    def to_druid(self):
        return {"type": "regex", "dimension": self.dimension, "pattern": self.pattern}


@dataclasses.dataclass(frozen=True)
class LikeFilter(Filter):
    """SQL LIKE — compiled to regex on the dictionary like `Regex`."""

    dimension: str
    pattern: str  # SQL pattern with % and _

    def to_druid(self):
        return {"type": "like", "dimension": self.dimension, "pattern": self.pattern}


@dataclasses.dataclass(frozen=True)
class And(Filter):
    fields: Tuple[Filter, ...]

    def to_druid(self):
        return {"type": "and", "fields": [f.to_druid() for f in self.fields]}


@dataclasses.dataclass(frozen=True)
class Or(Filter):
    fields: Tuple[Filter, ...]

    def to_druid(self):
        return {"type": "or", "fields": [f.to_druid() for f in self.fields]}


@dataclasses.dataclass(frozen=True)
class Not(Filter):
    field: Filter

    def to_druid(self):
        return {"type": "not", "field": self.field.to_druid()}


@dataclasses.dataclass(frozen=True)
class ExpressionFilter(Filter):
    """Residual scalar predicate over columns, compiled to element-wise
    tensor ops by `plan/expr.py` (the analog of Druid's JavaScript filter)."""

    expression: Any  # plan.expr.Expr

    def to_druid(self):
        return {"type": "expression", "expression": str(self.expression)}


@dataclasses.dataclass(frozen=True)
class IntervalFilter(Filter):
    """Half-open [start_ms, end_ms) intervals over the time column: the
    row-level residue of a time predicate (the query interval prunes whole
    segments)."""

    dimension: str  # usually "__time"
    intervals: Tuple[Tuple[int, int], ...]

    def to_druid(self):
        def fmt(iv):
            return f"{_ms_to_iso(iv[0])}/{_ms_to_iso(iv[1])}"

        return {
            "type": "interval",
            "dimension": self.dimension,
            "intervals": [fmt(iv) for iv in self.intervals],
        }


_MIN_ISO_MS = -62135596800000  # 0001-01-01
_MAX_ISO_MS = 253402300799999  # 9999-12-31


def _ms_to_iso(ms: int) -> str:
    """Integer-exact ISO-8601: float seconds lose the last millisecond near
    the range ends, and strftime %Y does not zero-pad years < 1000."""
    import datetime

    ms = max(_MIN_ISO_MS, min(int(ms), _MAX_ISO_MS))  # clamp open-bound sentinels
    sec, frac = divmod(ms, 1000)  # Python floor-div: exact for negatives too
    dt = datetime.datetime.fromtimestamp(sec, tz=datetime.timezone.utc)
    return (
        f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
        f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}.{frac:03d}Z"
    )


def filter_from_druid(d: Dict[str, Any]) -> Filter:
    """Parse Druid filter JSON back into the spec tree (wire-compat round trip)."""
    t = d["type"]
    if t == "selector":
        return Selector(d["dimension"], d.get("value"))
    if t == "in":
        vals = d["values"]
        return InFilter(
            d["dimension"],
            tuple(v for v in vals if v is not None),
            null_in_values=any(v is None for v in vals),
        )
    if t == "bound":
        return Bound(
            d["dimension"],
            d.get("lower"),
            d.get("upper"),
            d.get("lowerStrict", False),
            d.get("upperStrict", False),
            d.get("ordering", "lexicographic"),
        )
    if t == "regex":
        return Regex(d["dimension"], d["pattern"])
    if t == "like":
        return LikeFilter(d["dimension"], d["pattern"])
    if t == "and":
        return And(tuple(filter_from_druid(f) for f in d["fields"]))
    if t == "or":
        return Or(tuple(filter_from_druid(f) for f in d["fields"]))
    if t == "not":
        return Not(filter_from_druid(d["field"]))
    if t == "search":
        # contains / insensitive_contains map onto the Regex filter (same
        # O(dictionary) evaluation; re.escape keeps %/_/metacharacters
        # literal, which the LIKE translator cannot express)
        import re as _re

        q = d.get("query", {})
        qt = q.get("type")
        value = q.get("value", "")
        cs = q.get("case_sensitive", q.get("caseSensitive", True))
        insensitive = qt in (
            "insensitiveContains", "insensitive_contains"
        ) or (qt == "contains" and not cs)
        if qt not in ("contains", "insensitiveContains",
                      "insensitive_contains"):
            raise ValueError(f"unsupported search query type {qt!r}")
        pat = ("(?i)" if insensitive else "") + _re.escape(value)
        return Regex(d["dimension"], pat)
    if t == "interval":
        from .wire import intervals_from_druid

        return IntervalFilter(
            d.get("dimension", "__time"),
            intervals_from_druid(d.get("intervals", [])),
        )
    if t == "expression":
        from .wire import _expr

        return ExpressionFilter(_expr(d["expression"]))
    if t == "columnComparison":
        from ..plan import expr as E

        dims = d.get("dimensions", [])
        if len(dims) != 2 or not all(isinstance(x, str) for x in dims):
            raise ValueError(
                "columnComparison requires exactly two plain dimensions"
            )
        return ExpressionFilter(
            E.Comparison("==", E.Col(dims[0]), E.Col(dims[1]))
        )
    raise ValueError(f"unsupported filter type {t!r}")
