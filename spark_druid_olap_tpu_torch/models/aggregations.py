"""Aggregation + post-aggregation spec families — Druid JSON mirror.

Count, long/double sum/min/max, expression ("javascript") and filtered
aggregators; the sketch aggregators (hyperUnique, cardinality, thetaSketch,
quantilesDoublesSketch); and the arithmetic / fieldAccess / constant and
sketch-finalizing post-aggregators.  AVG arrives as a sum plus a count and
an arithmetic post-aggregation; approx_count_distinct as an HLL or theta
sketch.

`merge_op` names how partial states of one aggregator combine across
segments: "psum" adds, "pmin"/"pmax" take the extremum (HLL registers
take the max), "union" unions sketch samples (theta, quantiles).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from .filters import Filter


class Aggregation:
    name: str

    def to_druid(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def merge_op(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Count(Aggregation):
    name: str

    def to_druid(self):
        return {"type": "count", "name": self.name}

    merge_op = "psum"


@dataclasses.dataclass(frozen=True)
class LongSum(Aggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "longSum", "name": self.name, "fieldName": self.field_name}

    merge_op = "psum"


@dataclasses.dataclass(frozen=True)
class DoubleSum(Aggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "doubleSum", "name": self.name, "fieldName": self.field_name}

    merge_op = "psum"


@dataclasses.dataclass(frozen=True)
class LongMin(Aggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "longMin", "name": self.name, "fieldName": self.field_name}

    merge_op = "pmin"


@dataclasses.dataclass(frozen=True)
class LongMax(Aggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "longMax", "name": self.name, "fieldName": self.field_name}

    merge_op = "pmax"


@dataclasses.dataclass(frozen=True)
class DoubleMin(Aggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "doubleMin", "name": self.name, "fieldName": self.field_name}

    merge_op = "pmin"


@dataclasses.dataclass(frozen=True)
class DoubleMax(Aggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "doubleMax", "name": self.name, "fieldName": self.field_name}

    merge_op = "pmax"


@dataclasses.dataclass(frozen=True)
class HyperUnique(Aggregation):
    """Approximate COUNT(DISTINCT) via HyperLogLog register arrays.

    Druid's `hyperUnique` aggregates a pre-built HLL metric; its `cardinality`
    aggregator builds HLL from dimension values at query time.  Here both
    are the same op (ops/hll.py): hash -> (bucket, rho) -> per-group
    register-max.  Partial state = int32 registers[G, 2^p]; merge =
    element-wise max.
    """

    name: str
    field_name: str
    precision: int = 11  # 2^11 = 2048 registers; ~2.3% relative std error

    def to_druid(self):
        return {"type": "hyperUnique", "name": self.name, "fieldName": self.field_name}

    merge_op = "pmax"


@dataclasses.dataclass(frozen=True)
class CardinalityAgg(Aggregation):
    """Druid `cardinality` aggregator (HLL over dimension values at query time)."""

    name: str
    field_names: tuple
    by_row: bool = False
    precision: int = 11

    def to_druid(self):
        return {
            "type": "cardinality",
            "name": self.name,
            "fields": list(self.field_names),
            "byRow": self.by_row,
        }

    merge_op = "pmax"


@dataclasses.dataclass(frozen=True)
class ThetaSketch(Aggregation):
    """KMV/theta sketch distinct-count: keep the K smallest hashes.

    Partial state = sorted hashes[G, K]; merge = concat + sort + take-K
    (set union in the KMV sense), as Druid merges theta sketches on the
    broker.
    """

    name: str
    field_name: str
    size: int = 4096  # K

    def to_druid(self):
        return {
            "type": "thetaSketch",
            "name": self.name,
            "fieldName": self.field_name,
            "size": self.size,
        }

    merge_op = "union"


@dataclasses.dataclass(frozen=True)
class FilteredAgg(Aggregation):
    """Druid `filtered` aggregator: inner aggregation under an extra predicate
    (how `SUM(x) FILTER (WHERE p)` / conditional counts push down)."""

    filter: Filter
    aggregator: Aggregation

    @property
    def name(self):
        return self.aggregator.name

    def to_druid(self):
        return {
            "type": "filtered",
            "filter": self.filter.to_druid(),
            "aggregator": self.aggregator.to_druid(),
        }

    @property
    def merge_op(self):
        return self.aggregator.merge_op


@dataclasses.dataclass(frozen=True)
class ExpressionAgg(Aggregation):
    """Aggregate over a derived scalar expression (Druid's JavaScript
    aggregator slot): the expression compiles to element-wise tensor ops
    feeding the group-by.  `base` is the underlying exact aggregator
    (sum/min/max) applied to the expression's value."""

    name: str
    expression: Any  # plan.expr.Expr
    base: str = "doubleSum"  # doubleSum | doubleMin | doubleMax | longSum

    def to_druid(self):
        return {
            "type": "javascript",  # wire-compat slot the reference would use
            "name": self.name,
            "expression": str(self.expression),
            "base": self.base,
        }

    @property
    def merge_op(self):
        return {"doubleSum": "psum", "longSum": "psum", "doubleMin": "pmin",
                "doubleMax": "pmax"}[self.base]


# ----------------------------------------------------------------------------
# Post-aggregations (computed host-side over merged aggregate outputs — tiny)
# ----------------------------------------------------------------------------


class PostAggregation:
    name: str

    def to_druid(self) -> Dict[str, Any]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FieldAccess(PostAggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {"type": "fieldAccess", "name": self.name, "fieldName": self.field_name}


@dataclasses.dataclass(frozen=True)
class ConstantPost(PostAggregation):
    name: str
    value: float

    def to_druid(self):
        return {"type": "constant", "name": self.name, "value": self.value}


@dataclasses.dataclass(frozen=True)
class Arithmetic(PostAggregation):
    """fn in {+, -, *, /, quotient, pow}; fields are other post-aggs."""

    name: str
    fn: str
    fields: tuple  # Tuple[PostAggregation, ...]

    def to_druid(self):
        return {
            "type": "arithmetic",
            "name": self.name,
            "fn": self.fn,
            "fields": [f.to_druid() for f in self.fields],
        }


@dataclasses.dataclass(frozen=True)
class DimCodeMax(Aggregation):
    """max over a dimension's dictionary CODES — the carrier for
    functional-dependency grouping pruning.  When the planner drops a
    grouped column whose value is determined by another grouped column
    (a declared functional dependency), every
    row of a group shares one code for the pruned column, so max(code)
    recovers it; the API layer decodes code -> value host-side.  Internal
    wire extension type "dimCodeMax" (not part of Druid's dialect)."""

    name: str
    field_name: str

    def to_druid(self):
        return {
            "type": "dimCodeMax",
            "name": self.name,
            "fieldName": self.field_name,
        }

    merge_op = "pmax"


@dataclasses.dataclass(frozen=True)
class QuantilesSketch(Aggregation):
    """Approximate-quantile sketch (Druid `quantilesDoublesSketch` analog).

    State = per-group bottom-K random-priority value sample plus an exact
    N counter, int32[G, K+1, 2] (ops/quantiles.py); merge = concat +
    sort-by-priority + take-K, counters add.  The agg's own output column
    finalizes to the exact row count N (Druid's sketch finalization);
    quantile values come from the `QuantileFromSketch` post-agg
    (`APPROX_QUANTILE(col, p)` in SQL)."""

    name: str
    field_name: str
    size: int = 1024  # K; ~±1.5% rank error at the median

    def to_druid(self):
        return {
            "type": "quantilesDoublesSketch",
            "name": self.name,
            "fieldName": self.field_name,
            "k": self.size,
        }

    merge_op = "union"


@dataclasses.dataclass(frozen=True)
class HyperUniqueCardinality(PostAggregation):
    """Finalize an HLL state into a cardinality estimate."""

    name: str
    field_name: str

    def to_druid(self):
        return {
            "type": "hyperUniqueCardinality",
            "name": self.name,
            "fieldName": self.field_name,
        }


@dataclasses.dataclass(frozen=True)
class ThetaSketchEstimate(PostAggregation):
    name: str
    field_name: str

    def to_druid(self):
        return {
            "type": "thetaSketchEstimate",
            "name": self.name,
            "field": {"type": "fieldAccess", "fieldName": self.field_name},
        }


@dataclasses.dataclass(frozen=True)
class QuantileFromSketch(PostAggregation):
    """Finalize a quantiles-sketch state into the value at `fraction`
    (Druid `quantilesDoublesSketchToQuantile`)."""

    name: str
    field_name: str
    fraction: float

    def to_druid(self):
        return {
            "type": "quantilesDoublesSketchToQuantile",
            "name": self.name,
            "field": {"type": "fieldAccess", "fieldName": self.field_name},
            "fraction": self.fraction,
        }


@dataclasses.dataclass(frozen=True)
class ThetaSketchSetOp(PostAggregation):
    """Estimate of a set operation over theta sketch states (Druid's
    `thetaSketchSetOp` wrapped in `thetaSketchEstimate`): UNION / INTERSECT /
    NOT over the named thetaSketch aggregations in the same query.  Evaluated
    from raw per-group KMV states at finalize (ops/theta.py set_op_estimate)."""

    name: str
    fn: str  # "UNION" | "INTERSECT" | "NOT"
    field_names: Tuple[str, ...]

    def to_druid(self):
        return {
            "type": "thetaSketchEstimate",
            "name": self.name,
            "field": {
                "type": "thetaSketchSetOp",
                "name": f"{self.name}__setop",
                "func": self.fn,
                "fields": [
                    {"type": "fieldAccess", "fieldName": f}
                    for f in self.field_names
                ],
            },
        }
