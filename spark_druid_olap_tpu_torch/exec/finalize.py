"""Host-side result finalization: the broker's merge tail.

Everything that turns merged partial aggregate state (host numpy arrays)
into the result DataFrame: group-id decode, sketch estimates,
post-aggregations, having, sort/limit, empty-bucket fill and TopN ranking.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np

from ..catalog.segment import DataSource
from ..models import aggregations as A
from ..models import query as Q
from ..ops import hll, quantiles, theta
from ..utils.granularity import bucket_starts
from .lowering import LoweredAggs, ResolvedDim, sketch_ops


def finalize_timeseries(df, q: Q.TimeseriesQuery, ds: DataSource):
    """Timeseries finalization: empty-bucket zero-fill + ordering."""
    import pandas as pd

    tcol = q.output_name
    if not q.skip_empty_buckets:
        iv = q.intervals[0] if q.intervals else ds.interval()
        if iv is not None:
            lo = min(a for a, _ in q.intervals) if q.intervals else iv[0]
            hi = max(b for _, b in q.intervals) if q.intervals else iv[1]
            # interval ends are EXCLUSIVE: a bucket starting exactly at
            # `hi` is outside the query (Druid emits no zero bucket there)
            all_buckets = bucket_starts(
                lo, max(lo, hi - 1), q.granularity
            ).astype("datetime64[ms]")
            df = (
                df.set_index(tcol)
                .reindex(pd.Index(all_buckets, name=tcol))
                .reset_index()
            )
            for a in q.aggregations:
                if a.merge_op == "psum" and a.name in df:
                    filled = df[a.name].fillna(0)
                    if df[a.name].dtype.kind in ("i", "u"):
                        filled = filled.astype(np.int64)
                    df[a.name] = filled
    df = df.sort_values(tcol, ascending=not q.descending)
    return df.reset_index(drop=True)


def finalize_topn(df, q: Q.TopNQuery):
    """TopN ranking, including per-bucket ranking under a non-'all'
    granularity."""
    df = df.sort_values(q.metric, ascending=not q.descending, kind="stable")
    if q.granularity not in ("all", None):
        df = (
            df.groupby("timestamp", sort=True, group_keys=False)
            .head(q.threshold)
            .sort_values(
                ["timestamp", q.metric],
                ascending=[True, not q.descending],
                kind="stable",
            )
        )
        return df.reset_index(drop=True)
    return df.head(q.threshold).reset_index(drop=True)


# ---------------------------------------------------------------------------
# Post-aggregation / having / limit finalization (host-side, tiny)
# ---------------------------------------------------------------------------


def eval_post_agg(
    p: A.PostAggregation,
    table: Mapping[str, np.ndarray],
    states: Optional[Mapping[str, np.ndarray]] = None,
) -> np.ndarray:
    """`states` maps sketch-agg name -> raw per-group sketch state in the
    reference's layout (HLL registers / theta hash sets / quantile samples);
    sketch post-aggs finalize from the raw state, not from the
    already-finalized estimate column in `table`."""
    if isinstance(p, A.FieldAccess):
        return np.asarray(table[p.field_name])
    if isinstance(p, A.ConstantPost):
        return np.asarray(p.value)
    if isinstance(p, A.Arithmetic):
        vals = [eval_post_agg(f, table, states) for f in p.fields]
        acc = vals[0].astype(np.float64)
        for v in vals[1:]:
            if p.fn == "+":
                acc = acc + v
            elif p.fn == "-":
                acc = acc - v
            elif p.fn == "*":
                acc = acc * v
            elif p.fn == "pow":
                acc = acc ** v
            elif p.fn in ("/", "quotient"):
                with np.errstate(divide="ignore", invalid="ignore"):
                    # x/0 -> 0 is Druid arithmetic-post-agg behavior; but a
                    # NULL numerator stays NULL (the AVG rewrite over a
                    # zero-row group divides NaN sum by 0 count and must
                    # yield SQL NULL, not 0)
                    acc = np.where(
                        v != 0,
                        acc / np.where(v == 0, 1, v),
                        np.where(np.isnan(acc), np.nan, 0.0),
                    )
            else:
                raise ValueError(f"arithmetic fn {p.fn!r}")
        return acc
    if isinstance(p, A.HyperUniqueCardinality):
        if states is None or p.field_name not in states:
            raise KeyError(
                f"hyperUniqueCardinality over {p.field_name!r}: no raw HLL "
                "state available (field must name a hyperUnique/cardinality "
                "aggregation in the same query)"
            )
        return hll.estimate(states[p.field_name])
    if isinstance(p, A.QuantileFromSketch):
        if states is None or p.field_name not in states:
            raise KeyError(
                f"quantilesDoublesSketchToQuantile over {p.field_name!r}: "
                "no raw quantiles state available (field must name a "
                "quantilesDoublesSketch aggregation in the same query)"
            )
        return quantiles.estimate(states[p.field_name], p.fraction)
    if isinstance(p, A.ThetaSketchEstimate):
        if states is None or p.field_name not in states:
            raise KeyError(
                f"thetaSketchEstimate over {p.field_name!r}: no raw theta "
                "state available (field must name a thetaSketch aggregation "
                "in the same query)"
            )
        return theta.estimate(states[p.field_name])
    if isinstance(p, A.ThetaSketchSetOp):
        bad = [
            f
            for f in p.field_names
            if states is None
            or f not in states
            # theta KMV states are uint32 hash arrays; an HLL register
            # array here would silently produce a garbage estimate
            or np.asarray(states[f]).dtype != np.uint32
        ]
        if bad:
            raise KeyError(
                f"thetaSketchSetOp over {bad}: fields must name "
                "thetaSketch aggregations in the same query"
            )
        return theta.set_op_estimate(p.fn, [states[f] for f in p.field_names])
    raise NotImplementedError(f"post-aggregation {type(p).__name__}")


def _eval_having(h: Q.Having, table: Mapping[str, np.ndarray]) -> np.ndarray:
    if isinstance(h, Q.HavingCompare):
        v = np.asarray(table[h.aggregation], dtype=np.float64)
        return {
            ">": v > h.value,
            "<": v < h.value,
            ">=": v >= h.value,
            "<=": v <= h.value,
            "==": v == h.value,
            "!=": v != h.value,
        }[h.op]
    if isinstance(h, Q.HavingAnd):
        m = _eval_having(h.specs[0], table)
        for s in h.specs[1:]:
            m &= _eval_having(s, table)
        return m
    if isinstance(h, Q.HavingOr):
        m = _eval_having(h.specs[0], table)
        for s in h.specs[1:]:
            m |= _eval_having(s, table)
        return m
    if isinstance(h, Q.HavingNot):
        return ~_eval_having(h.spec, table)
    raise NotImplementedError(type(h).__name__)


def finalize_groupby(
    q: Q.GroupByQuery,
    dims: List[ResolvedDim],
    la: LoweredAggs,
    sums: np.ndarray,
    mins: np.ndarray,
    maxs: np.ndarray,
    sketch_states: Mapping[str, np.ndarray],
):
    """Merged partial state -> result DataFrame (decode, sketch estimates,
    post-aggs, having, order/limit).  `sketch_states` are host arrays in the
    reference's layout (`exec/engine.sketch_states_to_reference`)."""
    import pandas as pd

    rows_per_group = sums[:, 0]
    present = rows_per_group > 0
    if not dims:
        # SQL: a global aggregate always yields one row (COUNT=0, SUM/
        # MIN/MAX=NULL when nothing matched) — never an empty result
        present = np.ones_like(present, dtype=bool)
    sel = np.nonzero(present)[0]
    idx = sel.astype(np.int64)
    empty_group = rows_per_group[sel] == 0

    table: Dict[str, np.ndarray] = {}
    # decode combined gid -> per-dimension codes (row-major order)
    rem = idx
    codes_list = []
    for d in reversed(dims):
        codes_list.append((rem % d.cardinality).astype(np.int64))
        rem = rem // d.cardinality
    codes_list.reverse()
    for d, codes in zip(dims, codes_list):
        table[d.spec.name] = d.decode(codes)

    for j, n in enumerate(la.sum_names):
        if n == "__rows":
            continue
        v = sums[sel, j].astype(np.float64)
        if n in la.count_like or not empty_group.any():
            table[n] = np.rint(v).astype(np.int64) if la.long_valued[n] else v
        else:
            # SQL: SUM over zero rows is NULL; COUNT stays 0
            table[n] = np.where(empty_group, np.nan, v)
    for n, src in la.aliased.items():
        # unfiltered COUNT reads the __rows presence counter directly
        j = la.sum_names.index(src)
        table[n] = np.rint(sums[sel, j].astype(np.float64)).astype(np.int64)
    def _finalize_extremum(v: np.ndarray, long_valued: bool) -> np.ndarray:
        v = v.astype(np.float64)
        v = np.where(np.isinf(v), np.nan, v)
        if long_valued and not np.isnan(v).any():
            return np.rint(v).astype(np.int64)
        return v

    for j, n in enumerate(la.min_names):
        table[n] = _finalize_extremum(mins[sel, j], la.long_valued[n])
    for j, n in enumerate(la.max_names):
        table[n] = _finalize_extremum(maxs[sel, j], la.long_valued[n])

    raw_states: Dict[str, np.ndarray] = {}
    for agg in la.sketch_aggs:
        st = sketch_states[agg.name][sel]
        raw_states[agg.name] = st
        table[agg.name] = sketch_ops(agg).finalize(agg, st)

    for p in q.post_aggregations:
        table[p.name] = np.broadcast_to(
            eval_post_agg(p, table, raw_states), sel.shape
        ).copy()

    if q.having is not None:
        m = _eval_having(q.having, table)
        table = {k: np.asarray(v)[m] for k, v in table.items()}

    df = pd.DataFrame(table)
    if q.limit_spec is not None:
        df = apply_limit_spec(df, q.limit_spec)
    return df.reset_index(drop=True)


def apply_limit_spec(df, ls):
    """Sort/offset/limit per a LimitSpec; null keys order last."""
    if ls.columns:
        df = df.sort_values(
            [c.dimension for c in ls.columns],
            ascending=[c.direction == "ascending" for c in ls.columns],
            kind="stable",
            na_position="last",
        )
    if ls.offset:
        df = df.iloc[ls.offset:]
    if ls.limit is not None:
        df = df.head(ls.limit)
    return df
