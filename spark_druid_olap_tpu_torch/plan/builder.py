"""QueryBuilder — the immutable accumulator threaded through rewrite rules.

Reference parity: `DruidQueryBuilder` (SURVEY.md §2 `[U]`, expected
`org/sparklinedata/druid/DruidQueryBuilder.scala`): an immutable state object
each transform extends — dimensions, aggregations, post-aggs, filters,
interval, limit, output-attribute mapping, AVG-rewrite bookkeeping — with
failure at any stage dropping the rewrite candidate.  Same shape here;
`build()` picks the most specific query type (Timeseries ⊂ TopN ⊂ GroupBy,
§3.2) exactly as `DruidPlanner` does when choosing among candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..models import aggregations as A
from ..models import query as Q
from ..models.dimensions import DimensionSpec
from ..models.filters import Filter
from .expr import Expr


@dataclasses.dataclass(frozen=True)
class QueryBuilder:
    datasource: str
    dimensions: Tuple[DimensionSpec, ...] = ()
    aggregations: Tuple[A.Aggregation, ...] = ()
    post_aggregations: Tuple[A.PostAggregation, ...] = ()
    filter: Optional[Filter] = None
    intervals: Tuple[Tuple[int, int], ...] = ()
    having: Optional[Q.Having] = None
    limit_spec: Optional[Q.LimitSpec] = None
    virtual_columns: Tuple[Q.VirtualColumn, ...] = ()
    granularity: str = "all"
    # TopN candidate state (LimitTransform)
    topn_metric: Optional[str] = None
    topn_threshold: Optional[int] = None
    topn_descending: bool = True
    # bookkeeping
    output_columns: Tuple[str, ...] = ()  # SELECT-order output names
    residual_having: Optional[Expr] = None  # host-evaluated HAVING residue
    host_post_exprs: Tuple[Tuple[str, Expr], ...] = ()  # host-eval projections
    grouping_sets: Tuple[Tuple[int, ...], ...] = ()

    def with_(self, **kw) -> "QueryBuilder":
        return dataclasses.replace(self, **kw)

    def add_filter(self, f: Filter) -> "QueryBuilder":
        from ..models.filters import And

        if self.filter is None:
            return self.with_(filter=f)
        return self.with_(filter=And((self.filter, f)))

    def add_interval(self, iv: Tuple[int, int]) -> "QueryBuilder":
        return self.with_(intervals=self.intervals + (iv,))

    def add_virtual(self, vc: Q.VirtualColumn) -> "QueryBuilder":
        if any(v.name == vc.name for v in self.virtual_columns):
            return self
        return self.with_(virtual_columns=self.virtual_columns + (vc,))

    # -- query-type choice ---------------------------------------------------

    @property
    def is_timeseries(self) -> bool:
        return (
            len(self.dimensions) == 1
            and self.dimensions[0].dimension == "__time"
            and self.dimensions[0].granularity is not None
            # an extraction folds buckets (EXTRACT(MONTH...)): the result is
            # keyed by the extracted value, not the bucket timeline
            and self.dimensions[0].extraction is None
            and self.topn_threshold is None
            and not self.grouping_sets
            # TimeseriesQuery has no limit/sort/having surface — emitting it
            # anyway would silently drop them (fuzz seed 31); stay GroupBy
            and self.limit_spec is None
            and self.having is None
        )

    @property
    def is_topn(self) -> bool:
        return (
            len(self.dimensions) == 1
            and self.dimensions[0].granularity is None
            and self.topn_threshold is not None
            and self.topn_metric is not None
            and self.having is None
            and not self.grouping_sets
        )

    def build(self) -> Q.QuerySpec:
        """Most specific query type wins: Timeseries ⊂ TopN ⊂ GroupBy."""
        if self.is_timeseries:
            return Q.TimeseriesQuery(
                datasource=self.datasource,
                granularity=self.dimensions[0].granularity,  # type: ignore[arg-type]
                aggregations=self.aggregations,
                post_aggregations=self.post_aggregations,
                filter=self.filter,
                intervals=self.intervals,
                virtual_columns=self.virtual_columns,
                output_name=self.dimensions[0].name,
            )
        if self.is_topn:
            return Q.TopNQuery(
                datasource=self.datasource,
                dimension=self.dimensions[0],
                metric=self.topn_metric,  # type: ignore[arg-type]
                threshold=self.topn_threshold,  # type: ignore[arg-type]
                aggregations=self.aggregations,
                post_aggregations=self.post_aggregations,
                filter=self.filter,
                intervals=self.intervals,
                granularity=self.granularity,
                virtual_columns=self.virtual_columns,
                descending=self.topn_descending,
            )
        return Q.GroupByQuery(
            datasource=self.datasource,
            dimensions=self.dimensions,
            aggregations=self.aggregations,
            post_aggregations=self.post_aggregations,
            filter=self.filter,
            having=self.having,
            limit_spec=self.limit_spec,
            intervals=self.intervals,
            granularity=self.granularity,
            virtual_columns=self.virtual_columns,
            subtotals=self.grouping_sets,
        )
