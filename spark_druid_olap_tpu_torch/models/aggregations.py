"""Aggregation + post-aggregation spec families — Druid JSON mirror.

Count, long/double sum/min/max, expression ("javascript") and filtered
aggregators, and the arithmetic / fieldAccess / constant post-aggregators.
AVG arrives as a sum plus a count and an arithmetic post-aggregation.
Sketch aggregators come with a later part of the port.

`merge_op` names how partial states of one aggregator combine across
segments: "psum" adds, "pmin"/"pmax" take the extremum.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

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

