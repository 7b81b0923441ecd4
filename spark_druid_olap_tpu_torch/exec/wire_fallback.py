"""Host fallback of Druid-native queries: a wire QuerySpec decoded into the
logical plan `exec/fallback.py` interprets.

`api.TPUOlapContext.execute_native_degraded` answers a native spec on the
host, as the SQL path answers a plan the planner cannot rewrite:

  * every aggregate query type goes through its GroupBy form (the engine's
    own `timeseries_to_groupby` / `topn_to_groupby`, and the implicit time
    bucket of a query-level granularity), so the host and device paths
    cannot drift apart;
  * aggregators translate through the `WIRE_AGG_FALLBACK` registry
    (`exec/fallback.py`);
  * Druid filters become `plan.expr` predicates over decoded frames, and
    query intervals become time-column range predicates;
  * results re-shape through the engine's own finalizers (the Timeseries
    bucket fill, the TopN ranking, `apply_limit_spec`), so the answer has
    the shape the device path gives.

Specs outside the interpreter's coverage (extraction dimensions, virtual
columns, sketch set operations, week granularity) raise
`WireFallbackUnsupported` rather than risk a wrong answer.  Nothing routes
here on its own: the caller asks for the host path by name.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..models import aggregations as A
from ..models import filters as F
from ..models import query as Q
from ..plan import expr as E
from ..plan import logical as L
from ..utils.granularity import granularity_period_ms
from .fallback import fallback_agg_fn
from .finalize import apply_limit_spec, finalize_timeseries, finalize_topn
from .lowering import (
    groupby_with_time_granularity,
    timeseries_to_groupby,
    topn_to_groupby,
)

class WireFallbackUnsupported(NotImplementedError):
    """The native spec is outside the host interpreter's coverage."""


# ExpressionAgg base -> host aggregate function
_EXPR_AGG_BASE = {
    "doubleSum": "sum",
    "longSum": "sum",
    "doubleMin": "min",
    "doubleMax": "max",
}

_HAVING_OPS = {
    ">": ">", "<": "<", "==": "==", ">=": ">=", "<=": "<=", "!=": "!=",
}


def _col(name: str) -> E.Expr:
    return E.Col(name)


def _lit(v) -> E.Expr:
    return E.Literal(v)


def filter_to_expr(f: F.Filter, ds) -> E.Expr:
    """Druid filter tree -> a host-evaluable predicate over DECODED
    values.  Every branch mirrors the device filter compiler's semantics
    (ops/filters.py) over the decoded domain; anything that cannot be
    mirrored soundly raises rather than approximating."""
    if isinstance(f, F.Selector):
        return E.Comparison("==", _col(f.dimension), _lit(f.value))
    if isinstance(f, F.InFilter):
        # x IN (..., NULL) needs no special casing: non-members are
        # UNKNOWN, which a WHERE treats as false — the positive set
        # alone is equivalent, so null_in_values never changes the plan
        return E.InExpr(_col(f.dimension), tuple(f.values))
    if isinstance(f, F.Bound):
        terms: List[E.Expr] = []
        numeric = f.ordering == "numeric"

        def _bound_lit(s: str):
            if not numeric:
                return _lit(s)
            try:
                return _lit(float(s))
            except (TypeError, ValueError):
                raise WireFallbackUnsupported(
                    f"numeric bound with non-numeric literal {s!r}"
                )

        if f.lower is not None:
            terms.append(
                E.Comparison(
                    ">" if f.lower_strict else ">=",
                    _col(f.dimension), _bound_lit(f.lower),
                )
            )
        if f.upper is not None:
            terms.append(
                E.Comparison(
                    "<" if f.upper_strict else "<=",
                    _col(f.dimension), _bound_lit(f.upper),
                )
            )
        if not terms:
            return _lit(True)
        return terms[0] if len(terms) == 1 else E.BoolOp(
            "and", tuple(terms)
        )
    if isinstance(f, F.LikeFilter):
        return E.LikeExpr(_col(f.dimension), f.pattern)
    if isinstance(f, F.And):
        return E.BoolOp(
            "and", tuple(filter_to_expr(x, ds) for x in f.fields)
        )
    if isinstance(f, F.Or):
        return E.BoolOp(
            "or", tuple(filter_to_expr(x, ds) for x in f.fields)
        )
    if isinstance(f, F.Not):
        return E.BoolOp("not", (filter_to_expr(f.field, ds),))
    if isinstance(f, F.ExpressionFilter):
        return f.expression
    if isinstance(f, F.IntervalFilter):
        return _intervals_expr(f.intervals, ds)
    raise WireFallbackUnsupported(
        f"filter type {type(f).__name__} has no host interpretation"
    )


def _time_col(ds) -> str:
    tc = getattr(ds, "time_column", None)
    if not tc:
        raise WireFallbackUnsupported(
            f"time-scoped native query over timeless datasource "
            f"{ds.name!r}"
        )
    return tc


def _intervals_expr(intervals, ds) -> E.Expr:
    tc = _time_col(ds)
    terms = tuple(
        E.BoolOp(
            "and",
            (
                E.Comparison(">=", _col(tc), _lit(int(a))),
                E.Comparison("<", _col(tc), _lit(int(b))),
            ),
        )
        for a, b in intervals
    )
    if not terms:
        return _lit(True)
    return terms[0] if len(terms) == 1 else E.BoolOp("or", terms)


def _agg_to_aggexpr(
    a: A.Aggregation, quantile_posts, ds=None
) -> Optional[L.AggExpr]:
    """One wire aggregator -> the interpreter's AggExpr, via the
    WIRE_AGG_FALLBACK registry (fallback_agg_fn raises loudly for
    classes outside it).  Quantile sketches return None here — they are
    materialized by their consuming post-agg (quantile_posts)."""
    if isinstance(a, A.FilteredAgg):
        inner = _agg_to_aggexpr(a.aggregator, quantile_posts, ds)
        if inner is None:
            raise WireFallbackUnsupported(
                "filtered quantile sketches are not interpretable"
            )
        return dataclasses.replace(
            inner, filter=filter_to_expr(a.filter, ds)
        )
    fn = fallback_agg_fn(a)  # raises NotImplementedError off-registry
    if isinstance(a, A.Count):
        return L.AggExpr(a.name, "count", None)
    if isinstance(a, A.ExpressionAgg):
        base_fn = _EXPR_AGG_BASE.get(a.base)
        if base_fn is None:
            raise WireFallbackUnsupported(
                f"expression aggregator base {a.base!r}"
            )
        return L.AggExpr(a.name, base_fn, a.expression)
    if isinstance(a, A.CardinalityAgg):
        if a.by_row or len(a.field_names) != 1:
            raise WireFallbackUnsupported(
                "multi-field/by-row cardinality aggregator"
            )
        return L.AggExpr(a.name, fn, _col(a.field_names[0]))
    if isinstance(a, A.QuantilesSketch):
        # consumed by quantilesDoublesSketchToQuantile post-aggs; a bare
        # sketch output has no scalar host representation
        return None
    field = getattr(a, "field_name", None)
    if field is None:
        raise WireFallbackUnsupported(
            f"aggregator {type(a).__name__} without a fieldName"
        )
    return L.AggExpr(a.name, fn, _col(field))


_ARITH_OPS = {"+": "+", "-": "-", "*": "*", "/": "/", "quotient": "/"}


def _post_to_expr(p: A.PostAggregation, agg_names) -> E.Expr:
    if isinstance(p, A.FieldAccess):
        return E.AggRef(p.field_name)
    if isinstance(p, A.ConstantPost):
        return E.Literal(p.value)
    if isinstance(p, A.Arithmetic):
        op = _ARITH_OPS.get(p.fn)
        if op is None:
            raise WireFallbackUnsupported(
                f"arithmetic post-aggregation fn {p.fn!r}"
            )
        out = _post_to_expr(p.fields[0], agg_names)
        for x in p.fields[1:]:
            out = E.BinaryOp(op, out, _post_to_expr(x, agg_names))
        return out
    if isinstance(p, A.HyperUniqueCardinality):
        return E.AggRef(p.field_name)
    if isinstance(p, A.ThetaSketchEstimate):
        return E.AggRef(p.field_name)
    if isinstance(p, A.ExpressionPost):
        # agg-output references arrive as Cols from the wire expression
        # grammar; rebind them to AggRefs (SQL alias semantics)
        return E.map_expr(
            p.expression,
            lambda x: E.AggRef(x.name)
            if isinstance(x, E.Col) and x.name in agg_names
            else x,
        )
    raise WireFallbackUnsupported(
        f"post-aggregation {type(p).__name__} has no host interpretation"
    )


def _having_to_expr(h: Q.Having) -> E.Expr:
    if isinstance(h, Q.HavingCompare):
        op = _HAVING_OPS.get(h.op)
        if op is None:
            raise WireFallbackUnsupported(f"having op {h.op!r}")
        return E.Comparison(op, E.AggRef(h.aggregation), _lit(h.value))
    if isinstance(h, Q.HavingAnd):
        return E.BoolOp(
            "and", tuple(_having_to_expr(x) for x in h.specs)
        )
    if isinstance(h, Q.HavingOr):
        return E.BoolOp("or", tuple(_having_to_expr(x) for x in h.specs))
    if isinstance(h, Q.HavingNot):
        return E.BoolOp("not", (_having_to_expr(h.spec),))
    raise WireFallbackUnsupported(
        f"havingSpec {type(h).__name__} has no host interpretation"
    )


def _groupby_to_logical(q: Q.GroupByQuery, ds) -> L.LogicalPlan:
    if q.virtual_columns:
        raise WireFallbackUnsupported(
            "virtual columns in a native fallback query"
        )
    if q.subtotals:
        raise WireFallbackUnsupported(
            "subtotalsSpec in a native fallback query"
        )
    # grouping expressions
    group_exprs: List[Tuple[str, E.Expr]] = []
    for d in q.dimensions:
        if getattr(d, "extraction", None) is not None:
            raise WireFallbackUnsupported(
                f"extraction dimension {d.name!r}"
            )
        if d.dimension == "__time" or d.granularity:
            gran = d.granularity or "all"
            if gran.lower() == "all":
                continue  # a single all-time bucket adds no grouping key
            period = granularity_period_ms(gran)
            if period == 7 * 86_400_000:
                # Druid aligns weeks to Monday; the row-path TimeBucket
                # truncates from epoch — refusing beats a silent
                # misalignment
                raise WireFallbackUnsupported(
                    "week granularity in a native fallback query"
                )
            group_exprs.append(
                (d.name, E.TimeBucket(_col(_time_col(ds)), gran))
            )
        else:
            group_exprs.append((d.name, _col(d.dimension)))
    # aggregators; quantile sketches materialize via their consuming
    # post-aggs (fraction lives on the post-agg, not the sketch)
    quantile_sketches = {
        a.name: a
        for a in q.aggregations
        if isinstance(a, A.QuantilesSketch)
    }
    agg_exprs: List[L.AggExpr] = []
    for a in q.aggregations:
        ae = _agg_to_aggexpr(a, quantile_sketches, ds)
        if ae is not None:
            agg_exprs.append(ae)
    consumed_quantiles = set()
    for p in q.post_aggregations:
        if isinstance(p, A.QuantileFromSketch):
            sk = quantile_sketches.get(p.field_name)
            if sk is None:
                raise WireFallbackUnsupported(
                    f"quantile post-agg over unknown sketch "
                    f"{p.field_name!r}"
                )
            agg_exprs.append(
                L.AggExpr(
                    p.name, "approx_quantile", _col(sk.field_name),
                    args=(float(p.fraction),),
                )
            )
            consumed_quantiles.add(p.field_name)
    for name in quantile_sketches:
        if name not in consumed_quantiles:
            raise WireFallbackUnsupported(
                f"bare quantiles sketch {name!r} (no consuming post-agg)"
            )
    agg_names = {ae.name for ae in agg_exprs}
    # output projection: dims + aggs + post-aggs (quantile posts became
    # aggs above and project under their own names already)
    post: List[Tuple[str, E.Expr]] = [
        (n, _col(n)) for n, _ in group_exprs
    ] + [(ae.name, E.AggRef(ae.name)) for ae in agg_exprs]
    for p in q.post_aggregations:
        if isinstance(p, A.QuantileFromSketch):
            continue
        post.append((p.name, _post_to_expr(p, agg_names)))
    # predicate: filter AND query intervals
    pred: Optional[E.Expr] = None
    if q.filter is not None:
        pred = filter_to_expr(q.filter, ds)
    if q.intervals:
        iv = _intervals_expr(q.intervals, ds)
        pred = iv if pred is None else E.BoolOp("and", (pred, iv))
    base: L.LogicalPlan = L.Scan(q.datasource)
    if pred is not None:
        base = L.Filter(pred, base)
    plan: L.LogicalPlan = L.Aggregate(
        tuple(group_exprs), tuple(agg_exprs), base,
        post_exprs=tuple(post),
    )
    if q.having is not None:
        plan = L.Having(_having_to_expr(q.having), plan)
    return plan


def _scan_to_logical(q: Q.ScanQuery, ds) -> L.LogicalPlan:
    if q.virtual_columns:
        raise WireFallbackUnsupported(
            "virtual columns in a native fallback scan"
        )

    def resolve(name: str) -> E.Expr:
        if name == "__time":
            return _col(_time_col(ds))
        return _col(name)

    pred: Optional[E.Expr] = None
    if q.filter is not None:
        pred = filter_to_expr(q.filter, ds)
    if q.intervals:
        iv = _intervals_expr(q.intervals, ds)
        pred = iv if pred is None else E.BoolOp("and", (pred, iv))
    base: L.LogicalPlan = L.Scan(q.datasource)
    if pred is not None:
        base = L.Filter(pred, base)
    plan: L.LogicalPlan = L.Project(
        tuple((c, resolve(c)) for c in q.columns), base
    )
    if q.order_by:
        # the Sort sits ABOVE the Project, so keys must reference the
        # PROJECTED names — resolve() would re-resolve "__time" to the
        # raw time column the projection just renamed away
        for o in q.order_by:
            if o.dimension not in q.columns:
                raise WireFallbackUnsupported(
                    f"scan order-by {o.dimension!r} outside the "
                    "selected columns"
                )
        plan = L.Sort(
            tuple(
                L.SortKey(
                    _col(o.dimension), o.direction != "descending"
                )
                for o in q.order_by
            ),
            plan,
        )
    if q.limit is not None or q.offset:
        plan = L.Limit(
            q.limit if q.limit is not None else (1 << 62), plan, q.offset
        )
    return plan


def native_to_logical(q: Q.QuerySpec, ds) -> L.LogicalPlan:
    """QuerySpec -> logical plan for `execute_fallback`.  Aggregate
    types route through their GroupBy form (the engines' own rewrites);
    scan becomes Project/Filter/Sort/Limit.  Raises
    WireFallbackUnsupported outside the covered surface."""
    # Druid semantics shared by all executors: a non-'all' QUERY-level
    # granularity on groupBy/topN adds an implicit leading time-bucket
    # dimension (engine.execute applies the same rewrite) — without it
    # the degraded answer would silently collapse every time bucket
    if isinstance(q, Q.TimeseriesQuery):
        return _groupby_to_logical(timeseries_to_groupby(q), ds)
    if isinstance(q, Q.TopNQuery):
        return _groupby_to_logical(
            groupby_with_time_granularity(topn_to_groupby(q)), ds
        )
    if isinstance(q, Q.GroupByQuery):
        return _groupby_to_logical(groupby_with_time_granularity(q), ds)
    if isinstance(q, Q.ScanQuery):
        return _scan_to_logical(q, ds)
    raise WireFallbackUnsupported(
        f"{type(q).__name__} has no host-fallback interpretation"
    )


def shape_native_result(q: Q.QuerySpec, ds, df):
    """Re-shape the interpreter's grouped frame to what the DEVICE path
    would have produced, using the engines' own finalizers — the
    degraded wire response must be indistinguishable in shape from the
    healthy one."""
    if isinstance(q, Q.TimeseriesQuery):
        out = df.copy()
        tcol = q.output_name
        if tcol not in out.columns:
            # granularity "all": one all-time bucket anchored at the
            # scope start, exactly like the engine's time lowering
            iv = q.intervals[0] if q.intervals else ds.interval()
            lo = (
                min(a for a, _ in q.intervals) if q.intervals
                else (iv[0] if iv is not None else 0)
            )
            out.insert(0, tcol, np.int64(lo))
        out[tcol] = np.asarray(out[tcol], dtype=np.int64).astype(
            "datetime64[ms]"
        )
        return finalize_timeseries(out, q, ds)
    if isinstance(q, Q.TopNQuery):
            # non-'all' granularity: the interpreter ran the same implicit
        # time-bucket rewrite the engine does — re-type its ms ints to
        # timestamps before the topN finalizer renders per-bucket rows
        gq = groupby_with_time_granularity(topn_to_groupby(q))
        for d in gq.dimensions:
            if (
                (d.dimension == "__time" or d.granularity)
                and d.name in df.columns
            ):
                df = df.copy()
                df[d.name] = np.asarray(
                    df[d.name], dtype=np.int64
                ).astype("datetime64[ms]")
        return finalize_topn(df, q)
    if isinstance(q, Q.GroupByQuery):
            # see native_to_logical: the interpreter ran the granularity
        # rewrite, so the shaper must walk the SAME dimension list to
        # find (and re-type) the implicit leading time bucket
        q = groupby_with_time_granularity(q)
        out = df
        if q.dimensions and any(
            d.dimension == "__time" or d.granularity for d in q.dimensions
        ):
            for pos, d in enumerate(q.dimensions):
                if not (d.dimension == "__time" or d.granularity):
                    continue
                if d.name not in out.columns:
                    # granularity "all": the logical plan dropped the
                    # single all-time bucket from the grouping key; the
                    # device path still EMITS the column, anchored at the
                    # scope start — same contract as the timeseries
                    # branch above
                    iv = q.intervals[0] if q.intervals else ds.interval()
                    lo = (
                        min(a for a, _ in q.intervals) if q.intervals
                        else (iv[0] if iv is not None else 0)
                    )
                    out = out.copy()
                    out.insert(min(pos, len(out.columns)), d.name,
                               np.int64(lo))
                else:
                    out = out.copy()
                out[d.name] = np.asarray(
                    out[d.name], dtype=np.int64
                ).astype("datetime64[ms]")
        if q.limit_spec is not None:
            out = apply_limit_spec(out, q.limit_spec).reset_index(
                drop=True
            )
        return out
    return df
