"""Query specs — the compact execution contract between planner and engine.

GroupBy, TopN and Timeseries specs with their having, limit and ordering
parts, and the Scan, Search and metadata queries (TimeBoundary,
DataSourceMetadata, SegmentMetadata).  `exec/engine.py` executes them; `to_druid()` serializes them to
Druid's native JSON, the form the SQL planner's output is compared in.

A Timeseries is a GroupBy whose only dimension is the time bucket; a TopN is
a single-dimension GroupBy with a metric-ordered limit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from .aggregations import Aggregation, PostAggregation
from .dimensions import DimensionSpec
from .filters import Filter, _ms_to_iso


@dataclasses.dataclass(frozen=True)
class VirtualColumn:
    """Derived per-row scalar column computed on device before aggregation
    (e.g. `l_extendedprice * (1 - l_discount)`), compiled by `plan/expr.py`
    into element-wise tensor ops."""

    name: str
    expression: Any  # plan.expr.Expr
    dtype: str = "double"

    def to_druid(self):
        return {
            "type": "expression",
            "name": self.name,
            "expression": str(self.expression),
            "outputType": "DOUBLE" if self.dtype == "double" else "LONG",
        }


@dataclasses.dataclass(frozen=True)
class OrderByColumnSpec:
    dimension: str
    direction: str = "ascending"  # ascending | descending

    def to_druid(self):
        return {"dimension": self.dimension, "direction": self.direction}


@dataclasses.dataclass(frozen=True)
class LimitSpec:
    limit: Optional[int]
    columns: Tuple[OrderByColumnSpec, ...] = ()
    offset: int = 0

    def to_druid(self):
        d: Dict[str, Any] = {"type": "default"}
        if self.limit is not None:
            d["limit"] = self.limit
        if self.offset:
            d["offset"] = self.offset
        d["columns"] = [c.to_druid() for c in self.columns]
        return d


class QueryValidationError(ValueError):
    """A decoded query names something the datasource cannot satisfy
    (unknown orderBy column, time ordering on a timeless table) — a CLIENT
    error (HTTP 400), distinct from internal ValueErrors (500)."""


class Having:
    def to_druid(self) -> Dict[str, Any]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HavingCompare(Having):
    """aggregate <op> value, op in {>, <, ==, >=, <=, !=}."""

    aggregation: str
    op: str
    value: float

    def to_druid(self):
        m = {">": "greaterThan", "<": "lessThan", "==": "equalTo"}
        if self.op in m:
            return {
                "type": m[self.op],
                "aggregation": self.aggregation,
                "value": self.value,
            }
        inner = {">=": "lessThan", "<=": "greaterThan", "!=": "equalTo"}[self.op]
        return {
            "type": "not",
            "havingSpec": {
                "type": inner,
                "aggregation": self.aggregation,
                "value": self.value,
            },
        }


@dataclasses.dataclass(frozen=True)
class HavingAnd(Having):
    specs: Tuple[Having, ...]

    def to_druid(self):
        return {"type": "and", "havingSpecs": [s.to_druid() for s in self.specs]}


@dataclasses.dataclass(frozen=True)
class HavingOr(Having):
    specs: Tuple[Having, ...]

    def to_druid(self):
        return {"type": "or", "havingSpecs": [s.to_druid() for s in self.specs]}


@dataclasses.dataclass(frozen=True)
class HavingNot(Having):
    """Druid `not` havingSpec — needed to decode wire queries whose NOT
    wraps a compound spec (our own serializer only emits NOT around
    compares, which fold into >=/<=/!=)."""

    spec: Having

    def to_druid(self):
        return {"type": "not", "havingSpec": self.spec.to_druid()}


def _ivs(intervals):
    return [f"{_ms_to_iso(a)}/{_ms_to_iso(b)}" for a, b in intervals] or [
        "0000-01-01T00:00:00.000Z/3000-01-01T00:00:00.000Z"
    ]


class QuerySpec:
    """Base of all query specs."""

    datasource: str

    def to_druid(self) -> Dict[str, Any]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GroupByQuery(QuerySpec):
    datasource: str
    dimensions: Tuple[DimensionSpec, ...]
    aggregations: Tuple[Aggregation, ...]
    post_aggregations: Tuple[PostAggregation, ...] = ()
    filter: Optional[Filter] = None
    having: Optional[Having] = None
    limit_spec: Optional[LimitSpec] = None
    intervals: Tuple[Tuple[int, int], ...] = ()
    granularity: str = "all"
    virtual_columns: Tuple[VirtualColumn, ...] = ()
    # grouping-set support (GROUP BY CUBE/ROLLUP/GROUPING SETS): each entry is
    # a bitmask over `dimensions` marking which dims are active in that set.
    subtotals: Tuple[Tuple[int, ...], ...] = ()

    def to_druid(self):
        d: Dict[str, Any] = {
            "queryType": "groupBy",
            "dataSource": self.datasource,
            "granularity": self.granularity,
            "dimensions": [x.to_druid() for x in self.dimensions],
            "aggregations": [a.to_druid() for a in self.aggregations],
            "intervals": _ivs(self.intervals),
        }
        if self.virtual_columns:
            d["virtualColumns"] = [v.to_druid() for v in self.virtual_columns]
        if self.post_aggregations:
            d["postAggregations"] = [p.to_druid() for p in self.post_aggregations]
        if self.filter is not None:
            d["filter"] = self.filter.to_druid()
        if self.having is not None:
            d["having"] = self.having.to_druid()
        if self.limit_spec is not None:
            d["limitSpec"] = self.limit_spec.to_druid()
        if self.subtotals:
            d["subtotalsSpec"] = [
                [self.dimensions[i].name for i in s] for s in self.subtotals
            ]
        return d


@dataclasses.dataclass(frozen=True)
class TopNQuery(QuerySpec):
    datasource: str
    dimension: DimensionSpec
    metric: str  # aggregation/post-agg name to rank by
    threshold: int
    aggregations: Tuple[Aggregation, ...]
    post_aggregations: Tuple[PostAggregation, ...] = ()
    filter: Optional[Filter] = None
    intervals: Tuple[Tuple[int, int], ...] = ()
    granularity: str = "all"
    virtual_columns: Tuple[VirtualColumn, ...] = ()
    descending: bool = True

    def _metric_to_druid(self):
        """Druid wire metric spec.  Ranking by the dimension's own value is
        recognized by name — but only when no aggregation/post-agg claims
        that name (an aggregate deliberately named like the dimension must
        stay a numeric metric spec).  Descending dimension order uses
        Druid's inverted-wrapped lexicographic form; ascending aggregates
        the inverted wrapper."""
        agg_names = {a.name for a in self.aggregations} | {
            p.name for p in self.post_aggregations
        }
        if self.metric == self.dimension.name and self.metric not in agg_names:
            dim_spec = {"type": "dimension", "ordering": "lexicographic"}
            if self.descending:
                return {"type": "inverted", "metric": dim_spec}
            return dim_spec
        if self.descending:
            return self.metric
        return {"type": "inverted", "metric": self.metric}

    def to_druid(self):
        d: Dict[str, Any] = {
            "queryType": "topN",
            "dataSource": self.datasource,
            "granularity": self.granularity,
            "dimension": self.dimension.to_druid(),
            "metric": self._metric_to_druid(),
            "threshold": self.threshold,
            "aggregations": [a.to_druid() for a in self.aggregations],
            "intervals": _ivs(self.intervals),
        }
        if self.virtual_columns:
            d["virtualColumns"] = [v.to_druid() for v in self.virtual_columns]
        if self.post_aggregations:
            d["postAggregations"] = [p.to_druid() for p in self.post_aggregations]
        if self.filter is not None:
            d["filter"] = self.filter.to_druid()
        return d


@dataclasses.dataclass(frozen=True)
class TimeseriesQuery(QuerySpec):
    datasource: str
    granularity: str  # "hour", "day", ... or ISO period "PT1H"
    aggregations: Tuple[Aggregation, ...]
    post_aggregations: Tuple[PostAggregation, ...] = ()
    filter: Optional[Filter] = None
    intervals: Tuple[Tuple[int, int], ...] = ()
    virtual_columns: Tuple[VirtualColumn, ...] = ()
    descending: bool = False
    skip_empty_buckets: bool = True
    # result column for the bucket timestamp: "timestamp" is Druid's wire
    # name; SQL carries the user's alias (SELECT date_trunc(...) AS mo)
    output_name: str = "timestamp"

    def to_druid(self):
        d: Dict[str, Any] = {
            "queryType": "timeseries",
            "dataSource": self.datasource,
            "granularity": self.granularity,
            "aggregations": [a.to_druid() for a in self.aggregations],
            "intervals": _ivs(self.intervals),
            "descending": self.descending,
        }
        if self.virtual_columns:
            d["virtualColumns"] = [v.to_druid() for v in self.virtual_columns]
        if self.post_aggregations:
            d["postAggregations"] = [p.to_druid() for p in self.post_aggregations]
        if self.filter is not None:
            d["filter"] = self.filter.to_druid()
        if self.skip_empty_buckets:
            d["context"] = {"skipEmptyBuckets": True}
        if self.output_name != "timestamp":
            # not Druid wire vocabulary, but the serialized form is also the
            # program/result cache identity — two queries differing only in
            # the SQL alias must not collide
            d.setdefault("context", {})["outputName"] = self.output_name
        return d


@dataclasses.dataclass(frozen=True)
class ScanQuery(QuerySpec):
    """Row scan: the non-aggregate query (Druid's Scan), under the session's
    `non_aggregate_query_handling = 'scan'`."""

    datasource: str
    columns: Tuple[str, ...]
    filter: Optional[Filter] = None
    intervals: Tuple[Tuple[int, int], ...] = ()
    limit: Optional[int] = None
    virtual_columns: Tuple[VirtualColumn, ...] = ()
    # Druid scan `orderBy` (column-value ordering) + result offset; an
    # ordering the engine cannot honor must be a planner error, never a
    # silent drop — unsorted rows under LIMIT are wrong rows
    order_by: Tuple["OrderByColumnSpec", ...] = ()
    offset: int = 0
    # Druid scan resultFormat: "list" (events as dicts) or "compactedList"
    # (events as positional value arrays) — a WIRE-shape concern only
    result_format: str = "list"

    def to_druid(self):
        d: Dict[str, Any] = {
            "queryType": "scan",
            "dataSource": self.datasource,
            "columns": list(self.columns),
            "intervals": _ivs(self.intervals),
        }
        if self.result_format != "list":
            d["resultFormat"] = self.result_format
        if self.virtual_columns:
            d["virtualColumns"] = [v.to_druid() for v in self.virtual_columns]
        if self.filter is not None:
            d["filter"] = self.filter.to_druid()
        if self.limit is not None:
            d["limit"] = self.limit
        if self.order_by:
            d["orderBy"] = [
                {"columnName": c.dimension, "order": c.direction}
                for c in self.order_by
            ]
        if self.offset:
            d["offset"] = self.offset
        return d


@dataclasses.dataclass(frozen=True)
class SearchQuery(QuerySpec):
    """Dimension-value search (Druid `search`): the dimension values that
    contain a substring (case-insensitive), each with its count of matching
    rows.  The candidates come from the host dictionaries; the counts are
    taken on the device."""

    datasource: str
    dimensions: Tuple[str, ...]
    query: str  # case-insensitive contains
    filter: Optional[Filter] = None
    intervals: Tuple[Tuple[int, int], ...] = ()
    limit: int = 1000

    def to_druid(self):
        return {
            "queryType": "search",
            "dataSource": self.datasource,
            "searchDimensions": list(self.dimensions),
            "query": {"type": "insensitive_contains", "value": self.query},
            "intervals": _ivs(self.intervals),
            "limit": self.limit,
        }


@dataclasses.dataclass(frozen=True)
class DataSourceMetadataQuery(QuerySpec):
    """Druid `dataSourceMetadata`: the newest ingested event time, answered
    from segment metadata (no kernel dispatch)."""

    datasource: str

    def to_druid(self):
        return {
            "queryType": "dataSourceMetadata",
            "dataSource": self.datasource,
        }


@dataclasses.dataclass(frozen=True)
class TimeBoundaryQuery(QuerySpec):
    """Druid `timeBoundary`: min/max event time of a datasource, answered
    from segment metadata (no kernel dispatch)."""

    datasource: str
    bound: Optional[str] = None  # None -> both | "minTime" | "maxTime"

    def to_druid(self):
        d: Dict[str, Any] = {
            "queryType": "timeBoundary",
            "dataSource": self.datasource,
        }
        if self.bound:
            d["bound"] = self.bound
        return d


@dataclasses.dataclass(frozen=True)
class SegmentMetadataQuery(QuerySpec):
    """Druid `segmentMetadata`: per-segment column analysis (types,
    cardinalities, row counts): the catalog rendered in Druid's wire
    shape."""

    datasource: str
    intervals: Tuple[Tuple[int, int], ...] = ()

    def to_druid(self):
        d: Dict[str, Any] = {
            "queryType": "segmentMetadata",
            "dataSource": self.datasource,
        }
        if self.intervals:
            d["intervals"] = _ivs(self.intervals)
        return d
