"""Host (pandas) execution of logical plans the planner cannot rewrite.

When `Planner.plan` raises RewriteError (a subquery, a window, a set
operation, an unconforming join, an expression no transform covers), the
SAME logical plan is interpreted here over decoded host frames, as the
JAX package's `exec/fallback.py` does.  `api._run_fallback` routes to it
under `SessionConfig.fallback_execution` (True by default) and holds the
device-assist hook: every Aggregate subtree is offered to the normal
rewrite path first, so a GROUP BY under a window, a subquery or a set
operation scans on the card and only its aggregated frame is interpreted
here.

Semantics (the JAX package's, kept the same):
* COUNT(DISTINCT) and approx_count_distinct evaluate EXACTLY here (pandas
  nunique): the host has no reason to approximate.
* SUM/MIN/MAX/AVG over zero rows are SQL NULL; COUNT is 0.
* Grouping sets expand as on the device path: one pass per set, absent
  dimensions as nulls, a __grouping_id bitmask.
* Filters use Kleene three-valued logic (`_eval3`).

Expressions evaluate through `plan/expr.compile_host_expr`.  Columns are
decoded from the segments' host arrays (`Segment.column`), never copied
back from the card.

Deadlines (`resilience.py`): the decode checkpoints per segment
(`fallback.decode`, partial-capable: a truncated frame is a sound partial
input), the per-group loop every 256 groups (`fallback.group_loop`) and the
interpreter before each plan node (`fallback.interp`).  The collector's
scope spans every table a plan decodes; `_run_fallback` owns the pass.
Inside `drain_memo` the uncorrelated subqueries' answers are kept, so a
drain rerun takes the ones its first run finished instead of computing
them again.
"""


from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from collections import Counter
from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..catalog.segment import DataSource, row_counts
from ..models import aggregations as A
from ..plan import expr as E
from ..plan import logical as L
from ..plan.expr import Expr, compile_host_expr, map_expr
from ..obs import SPAN_FALLBACK_DECODE, span
from ..resilience import checkpoint, checkpoint_partial, current_partial, fire, injector, site_armed
from ..utils.lru import ByteBudgetCache, CountBudgetCache

# Every aggregation class maps to the host function `_agg_one` interprets
# it with, so an answer on the host never silently loses a feature the
# device path serves.  Distinct-count sketches evaluate exactly here.
WIRE_AGG_FALLBACK = {
    A.Count: "count",
    A.LongSum: "sum",
    A.DoubleSum: "sum",
    A.LongMin: "min",
    A.DoubleMin: "min",
    A.LongMax: "max",
    A.DoubleMax: "max",
    # the FD-pruning carrier: max over dictionary codes, decoded by the api
    A.DimCodeMax: "max",
    # its base ("doubleSum", "longSum", "doubleMin", "doubleMax") is one of
    # the functions above
    A.ExpressionAgg: "sum",
    # a wrapper: interpreted as the inner aggregator under AggExpr.filter
    A.FilteredAgg: "count",
    A.HyperUnique: "approx_count_distinct",
    A.CardinalityAgg: "approx_count_distinct",
    A.ThetaSketch: "approx_count_distinct_ds_theta",
    A.QuantilesSketch: "approx_quantile",
}


def fallback_agg_fn(agg: A.Aggregation) -> str:
    """The `_agg_one` function name that interprets `agg` on the host.
    Raises for classes outside the registry: the host answer would lose a
    feature the device path serves."""
    if isinstance(agg, A.FilteredAgg):
        return fallback_agg_fn(agg.aggregator)
    for cls, fn in WIRE_AGG_FALLBACK.items():
        if type(agg) is cls:
            return fn
    raise NotImplementedError(
        f"no host fallback interpretation for {type(agg).__name__}"
    )


# -- decode ---------------------------------------------------------------

# Per-(segment uid, column, dictionary content) decoded arrays, LRU under a
# byte budget: a repeated fallback query decodes nothing again, and a new
# segment set or dictionary misses cleanly.  Object arrays meter at pointer
# width; the decoded values are shared with the dictionary's tuple.
_DECODE_CACHE_BYTES = 1 << 30
_decode_cache: Optional[ByteBudgetCache] = None


def _decoded_segment_cache() -> ByteBudgetCache:
    global _decode_cache
    if _decode_cache is None:
        _decode_cache = ByteBudgetCache(_DECODE_CACHE_BYTES)
    return _decode_cache


def evict_decoded_segments(uids) -> None:
    """Drop the decoded arrays of retired segment uids (a dropped table, a
    cleared catalog)."""
    if _decode_cache is None:
        return
    uids = set(uids)
    for k in [k for k in _decode_cache if k[0] in uids]:
        _decode_cache.pop(k)


def decoded_frame(ds: DataSource, columns=None) -> pd.DataFrame:
    """The real rows of a datasource as a pandas frame, under a
    `fallback_decode` span (`_decoded_frame`)."""
    with span(SPAN_FALLBACK_DECODE, datasource=ds.name):
        return _decoded_frame(ds, columns)


def _decoded_frame(ds: DataSource, columns=None) -> pd.DataFrame:
    """The real rows of a datasource as a pandas frame: dimensions decoded
    to values (None for null), float metrics as float64, time as int64 ms.
    `columns` restricts the decode to the names a plan references.

    The decode runs segment by segment, a checkpoint before each
    (`fallback.decode`): a deadline that expires there under a partial
    collector truncates the frame to whole segments (every column the same
    row prefix), so the interpreter answers over the rows seen.  While the
    collector drains, a segment whose columns are all in the decode cache is
    still served, and the first that would need a decode ends the frame.
    The `fallback_decode` fault site fires first; armed in `partial` mode it
    truncates every segment's decode to a fraction, bypassing the cache."""
    fire("fallback_decode")
    frac = injector().partial_fraction("fallback_decode")
    cache = _decoded_segment_cache() if frac is None else None
    names = [c.name for c in ds.columns if columns is None or c.name in columns]
    dict_keys = {n: (ds.dicts[n].content_key if n in ds.dicts else None) for n in names}
    segs = list(ds.segments)
    pc = current_partial()
    if pc is not None:
        # the scope accumulates across the plan's tables: `_run_fallback`
        # owns the pass
        pc.add_scope(len(segs), *row_counts(segs))
    parts: Dict[str, list] = {n: [] for n in names}
    draining = False
    for seg in segs:
        if draining or checkpoint_partial("fallback.decode"):
            draining = True
            if cache is None or any(
                cache.get((seg.uid, "decoded", n, dict_keys[n])) is None for n in names
            ):
                break
        for n in names:
            key = (seg.uid, "decoded", n, dict_keys[n])
            arr = cache.get(key) if cache is not None else None
            if arr is None:
                arr = np.asarray(seg.column(n))[seg.valid]
                if n in ds.dicts:
                    arr = ds.dicts[n].decode(arr)
                elif arr.dtype.kind == "f":
                    arr = arr.astype(np.float64)
                if frac is not None:
                    arr = arr[: int(len(arr) * frac)]
                if cache is not None:
                    cache[key] = arr
            parts[n].append(arr)
        if pc is not None:
            pc.add_seen(1, *row_counts((seg,)))
    return pd.DataFrame({
        n: (np.concatenate(p) if p else np.array([], dtype=object)) for n, p in parts.items()
    })


def _plan_columns(lp: L.LogicalPlan) -> set:
    """Every column name an expression of the plan references (a superset
    per table: enough to bound the decode)."""
    cols: set = set()

    def from_expr(e):
        if isinstance(e, Expr):
            cols.update(e.columns())

    if isinstance(lp, L.Filter):
        from_expr(lp.condition)
    elif isinstance(lp, L.Project):
        for _, e in lp.exprs:
            from_expr(e)
    elif isinstance(lp, L.Join):
        cols.update(lp.left_keys)
        cols.update(lp.right_keys)
    elif isinstance(lp, L.Aggregate):
        for _, e in lp.group_exprs:
            from_expr(e)
        for ae in lp.agg_exprs:
            from_expr(ae.arg)
            from_expr(ae.filter)
        for _, e in lp.post_exprs:
            from_expr(e)
    elif isinstance(lp, L.Having):
        from_expr(lp.condition)
    elif isinstance(lp, L.Window):
        for w in lp.wins:
            for e in (w.arg, w.filter, *w.partition, *w.order_exprs):
                from_expr(e)
        for _, e in lp.out_exprs:
            from_expr(e)
    elif isinstance(lp, L.Sort):
        for k in lp.keys:
            from_expr(k.expr)
    for child in lp.children():
        cols |= _plan_columns(child)
    return cols


# -- expressions, filters, aggregates -------------------------------------


def _apply_mask(df: pd.DataFrame, mask) -> pd.DataFrame:
    """Row selection; a constant predicate (a resolved EXISTS) keeps or
    drops every row."""
    m = np.asarray(mask)
    if m.ndim == 0:
        return df if bool(m) else df.iloc[0:0]
    return df[m.astype(bool)]


class _FrameColumns:
    """A frame's columns as numpy arrays, each converted when an expression
    first reads it (a wide frame's string columns cost O(rows) each)."""

    def __init__(self, df: pd.DataFrame):
        self._df, self._arrays = df, {}

    def __getitem__(self, name):
        a = self._arrays.get(name)
        if a is None:
            a = self._arrays[name] = np.asarray(self._df[name])
        return a


def _eval(e: Expr, df: pd.DataFrame) -> np.ndarray:
    return np.asarray(compile_host_expr(e)(_FrameColumns(df)))


class _SubqNull(E.Literal):
    """A NULL that arrived as a VALUE (an empty or NULL scalar subquery),
    unlike the parser's `== Literal(None)` IS NULL encoding: comparing
    anything against it is UNKNOWN."""


def _is_null_lit(s) -> bool:
    return isinstance(s, E.Literal) and (
        s.value is None or (isinstance(s.value, float) and np.isnan(s.value))
    )


def _eval_memo(e: Expr, df: pd.DataFrame, memo) -> np.ndarray:
    """`_eval` memoized per filter: the Kleene evaluator reads each operand
    once for its value and once for its null mask."""
    if memo is None:
        return _eval(e, df)
    try:
        v = memo.get(e)
    except TypeError:  # an unhashable literal payload
        return _eval(e, df)
    if v is None:
        v = memo[e] = _eval(e, df)
    return v


def _null_rows(e: Expr, df: pd.DataFrame, memo=None) -> np.ndarray:
    """Per-row SQL NULL mask of a value expression (decoded dimensions hold
    None, metrics NaN)."""
    n = len(df)
    if isinstance(e, E.Literal):
        return np.full(n, _is_null_lit(e), dtype=bool)
    v = np.asarray(_eval_memo(e, df, memo))
    if v.ndim == 0:
        return np.full(n, bool(pd.isna(v[()])), dtype=bool)
    return np.asarray(pd.isna(v))


def _coerce_bool(v, n: int) -> np.ndarray:
    v = np.asarray(v)
    if v.ndim == 0:
        return np.full(n, bool(v), dtype=bool)
    return v.astype(bool)


def _eval3(e: Expr, df: pd.DataFrame, memo=None):
    """Kleene three-valued evaluation of a boolean expression: (true mask,
    unknown mask).  NOT UNKNOWN is UNKNOWN, where a two-valued NULL->False
    coalescing would turn it TRUE."""
    n = len(df)
    F = np.zeros(n, dtype=bool)

    if isinstance(e, E.BoolOp):
        parts = [_eval3(x, df, memo) for x in e.operands]
        if e.op == "not":
            t, u = parts[0]
            return ~t & ~u, u
        ts = [p[0] for p in parts]
        fs = [~p[0] & ~p[1] for p in parts]
        if e.op == "and":
            t, f = np.logical_and.reduce(ts), np.logical_or.reduce(fs)
        else:
            t, f = np.logical_or.reduce(ts), np.logical_and.reduce(fs)
        return t, ~t & ~f
    if isinstance(e, E.Comparison):
        lnull, rnull = _is_null_lit(e.left), _is_null_lit(e.right)
        if lnull or rnull:
            value_null = isinstance(e.left, _SubqNull) or isinstance(e.right, _SubqNull)
            if e.op in ("==", "!=") and not value_null:
                # the parser's IS [NOT] NULL encoding: two-valued
                isn = _null_rows(e.right if lnull else e.left, df, memo)
                return (isn if e.op == "==" else ~isn), F
            # a genuine NULL comparison value: UNKNOWN for every row
            return F, ~F
        u = _null_rows(e.left, df, memo) | _null_rows(e.right, df, memo)
        return _coerce_bool(_eval(e, df), n) & ~u, u
    if isinstance(e, E.InExpr):
        if not e.values:
            return F, F  # x IN () is FALSE for every x, even NULL
        vals = tuple(v for v in e.values if v is not None)
        u_op = _null_rows(e.operand, df, memo)
        if len(vals) != len(e.values):
            # a NULL in the list: TRUE for members, UNKNOWN for the rest
            t = (_coerce_bool(_eval(E.InExpr(e.operand, vals), df), n) & ~u_op
                 if vals else F)
            return t, ~t
        return _coerce_bool(_eval(e, df), n) & ~u_op, u_op
    if isinstance(e, E.LikeExpr):
        # NOT LIKE too: a NULL operand is UNKNOWN either way
        u = _null_rows(e.operand, df, memo)
        return _coerce_bool(_eval(e, df), n) & ~u, u
    if isinstance(e, E.Literal):
        if _is_null_lit(e):
            return F, ~F
        return np.full(n, bool(e.value), dtype=bool), F
    # any other boolean-valued expression (CASE, a cast): NULL is UNKNOWN
    v = np.asarray(_eval(e, df))
    if v.ndim == 0:
        return np.full(n, bool(v), dtype=bool), F
    u = np.asarray(pd.isna(v))
    return np.where(u, False, v).astype(bool), u


def _filter_mask(cond: Expr, df: pd.DataFrame) -> np.ndarray:
    t, _ = _eval3(cond, df, memo={})
    return t


_DISTINCT_FNS = ("count_distinct", "approx_count_distinct",
                 "approx_count_distinct_ds_theta", "approx_count_distinct_ds_hll")


def _agg_one(ae: L.AggExpr, df: pd.DataFrame):
    """One aggregate over (a filtered view of) one group's rows."""
    fn = ae.fn.lower()
    if ae.filter is not None:
        pre_n = len(df)
        df = df[_filter_mask(ae.filter, df)]
        if pre_n and not len(df):
            # a filtered aggregator over a non-empty group that matches no
            # row: additive aggregates 0 (AVG's 0/0 too), extrema NULL, as
            # the device engine answers
            if fn in ("sum", "avg"):
                return 0.0
            if fn.startswith("count") or fn.startswith("approx_count_distinct"):
                return 0
            return np.nan
    if fn == "count" and ae.arg is None and not ae.distinct:
        return len(df)
    arg = np.asarray(_eval(ae.arg, df)) if ae.arg is not None else np.ones(len(df))
    if fn in _DISTINCT_FNS or (fn == "count" and ae.distinct):
        return pd.Series(arg).nunique(dropna=True)
    if fn == "count":
        return int(pd.Series(arg).notna().sum())
    if fn == "approx_quantile":
        vals = pd.Series(arg).dropna().astype(np.float64)
        if not len(vals):
            return np.nan
        return float(np.quantile(vals, float(ae.args[0])))
    vals = pd.Series(arg, dtype=np.float64)
    if ae.distinct:
        # SUM/AVG(DISTINCT): exact here (the device engine refuses them)
        vals = vals.drop_duplicates()
    if not len(vals):
        return np.nan  # an aggregate over zero rows is NULL
    if fn == "sum":
        return vals.sum(min_count=1)  # SUM over all-NULL rows is NULL
    return {"min": vals.min, "max": vals.max, "avg": vals.mean}[fn]()


def _vectorized_set(node: L.Aggregate, df: pd.DataFrame, keys) -> Optional[pd.DataFrame]:
    """One pandas groupby for the plain shapes (sum, min, max, avg, count;
    unfiltered, not distinct) instead of a Python loop over the groups;
    None when an aggregate needs the per-group path."""
    for ae in node.agg_exprs:
        if (ae.fn.lower() not in ("sum", "min", "max", "avg", "count")
                or ae.filter is not None or ae.distinct):
            return None
    kf = pd.DataFrame({name: _eval(e, df) for name, e in keys}, index=df.index)
    if not node.agg_exprs:
        # the DISTINCT-keys shape (the EXISTS decorrelator emits it)
        return kf.drop_duplicates().reset_index(drop=True)
    if any(ae.name in kf.columns for ae in node.agg_exprs):
        return None  # an aggregate shadowing a group key: the exact path
    tmp = kf.copy()
    specs, fixups = {}, []  # fixups: SUM's NULL over all-NULL groups
    for i, ae in enumerate(node.agg_exprs):
        fn = ae.fn.lower()
        cn = f"__a{i}"
        if fn == "count" and ae.arg is None:
            tmp[cn] = np.ones(len(df))
            specs[ae.name] = (cn, "count")
            continue
        arg = np.asarray(_eval(ae.arg, df)) if ae.arg is not None else np.ones(len(df))
        if fn == "count":
            tmp[cn] = pd.Series(arg, index=df.index)
            specs[ae.name] = (cn, "count")
            continue
        tmp[cn] = pd.Series(arg, index=df.index, dtype=np.float64)
        specs[ae.name] = (cn, "mean" if fn == "avg" else fn)
        if fn == "sum":
            helper = f"__n{i}"
            specs[helper] = (cn, "count")
            fixups.append((ae.name, helper))
    out = tmp.groupby(list(kf.columns), dropna=False, sort=False).agg(**specs).reset_index()
    for name, helper in fixups:
        out.loc[out[helper] == 0, name] = np.nan
        out = out.drop(columns=[helper])
    return out[[n for n, _ in keys] + [ae.name for ae in node.agg_exprs]]


def _aggregate(node: L.Aggregate, df: pd.DataFrame) -> pd.DataFrame:
    def one_set(indices) -> pd.DataFrame:
        keys = [node.group_exprs[i] for i in indices]
        if not keys:
            return pd.DataFrame([{ae.name: _agg_one(ae, df) for ae in node.agg_exprs}])
        fast = _vectorized_set(node, df, keys)
        if fast is not None:
            return fast
        kf = pd.DataFrame({name: _eval(e, df) for name, e in keys}, index=df.index)
        rows = []
        grouped = df.groupby([kf[n] for n, _ in keys], dropna=False, sort=False)
        for i, (gv, gdf) in enumerate(grouped):
            if i % 256 == 0:  # the per-group Python loop of q18-class plans
                checkpoint("fallback.group_loop")
            gv = gv if isinstance(gv, tuple) else (gv,)
            row = dict(zip((n for n, _ in keys), gv))
            for ae in node.agg_exprs:
                row[ae.name] = _agg_one(ae, gdf)
            rows.append(row)
        return pd.DataFrame(rows, columns=[n for n, _ in keys] + [ae.name for ae in node.agg_exprs])

    if node.grouping_sets:
        k = len(node.group_exprs)
        frames = []
        for s in node.grouping_sets:
            f = one_set(s)
            gid = 0
            present = set(s)
            for i in range(k):
                if i not in present:
                    gid |= 1 << (k - 1 - i)
                    f[node.group_exprs[i][0]] = None
            f["__grouping_id"] = gid
            frames.append(f)
        out = pd.concat(frames, ignore_index=True)
        order = [n for n, _ in node.group_exprs]
        out = out[order + [c for c in out.columns if c not in order]]
    else:
        out = one_set(range(len(node.group_exprs)))
    # post-aggregate expressions, no projection: an enclosing Sort or
    # Having may read group columns or hidden helpers; the SELECT list is
    # projected once, at the root
    for name, pe in node.post_exprs:
        if isinstance(pe, E.Col) and pe.name in out.columns:
            if name != pe.name:
                out[name] = out[pe.name]  # a SELECT alias of a group column
            continue
        out[name] = _eval(_refs_to_cols(pe), out)
    return out


def _refs_to_cols(e: Expr) -> Expr:
    """AggRef -> Col, so expressions over a result frame compile."""
    if isinstance(e, E.AggRef):
        return E.Col(e.name)
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            kw[f.name] = _refs_to_cols(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], Expr):
            kw[f.name] = tuple(_refs_to_cols(x) for x in v)
    return dataclasses.replace(e, **kw) if kw else e


def _needs_all_columns(lp: L.LogicalPlan, under_project: bool = False) -> bool:
    """True when a Scan reaches the root with no Project, Aggregate or
    Window above it (SELECT *): every column of its table is output."""
    if isinstance(lp, L.Scan):
        return not under_project
    if isinstance(lp, L.SubqueryScan):
        return _needs_all_columns(lp.child, under_project)
    up = under_project or isinstance(lp, (L.Project, L.Aggregate, L.Window))
    return any(_needs_all_columns(c, up) for c in lp.children())


def _pruned_columns(lp: L.LogicalPlan):
    return None if _needs_all_columns(lp) else (_plan_columns(lp) or None)


def _select_list(lp: L.LogicalPlan):
    """The output column list: the outermost Project's names, or the
    outermost Aggregate's SELECT items; None for SELECT *."""
    if isinstance(lp, (L.Limit, L.Sort, L.Having)):
        return _select_list(lp.children()[0])
    if isinstance(lp, L.Window):
        return [n for n, _ in lp.out_exprs]
    if isinstance(lp, L.Union):
        return _select_list(lp.branches[0])  # branches align to the first
    if isinstance(lp, L.Project):
        return [n for n, _ in lp.exprs]
    if isinstance(lp, L.Aggregate):
        if lp.post_exprs:
            return [n for n, _ in lp.post_exprs]
        return [n for n, _ in lp.group_exprs] + [
            ae.name for ae in lp.agg_exprs if not ae.name.startswith("__agg")
        ]
    return None


def assist_columns(lp: L.Aggregate):
    """The columns an Aggregate node declares, which a frame the device
    assist returns for it must carry."""
    return ([n for n, _ in lp.group_exprs] + [ae.name for ae in lp.agg_exprs]
            + [n for n, _ in lp.post_exprs])


# -- subqueries -----------------------------------------------------------


def _inner_plan(sub, stmt=None) -> L.LogicalPlan:
    from ..sql.parser import Analyzer

    return Analyzer(stmt if stmt is not None else sub.stmt, dict(sub.aliases or ())).to_logical()


def _one_column(inner: pd.DataFrame, what: str) -> None:
    if inner.shape[1] != 1:
        raise ValueError(f"{what} subquery must produce exactly one column")


def _scalar_value(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


# id(subquery node) -> (the node, its answer, the collector's scope and
# seen counts its computation added), while `drain_memo` is open
_subquery_memo = contextvars.ContextVar("fallback_subquery_memo", default=None)


@contextlib.contextmanager
def drain_memo():
    """A scope whose fallback runs keep their uncorrelated subqueries'
    answers: `api._run_fallback` holds one around a query's first run and
    its drain, so the drain takes every subquery the first run finished
    (the same rows from the decode cache, so the same answer) instead of
    computing it again."""
    token = _subquery_memo.set({})
    try:
        yield
    finally:
        _subquery_memo.reset(token)


def _collector_counts(pc):
    if pc is None:
        return (0, 0, 0, 0)
    return (pc.segments_total, pc.rows_total, pc.segments_seen, pc.rows_seen)


def _subquery_frame(e, catalog) -> pd.DataFrame:
    """An uncorrelated subquery's answer; inside `drain_memo` a finished
    one is kept and served again, its collector counts added again, so a
    drain's accounting is a full rerun's.  One computed after the collector
    triggered (over a truncated decode) is not kept."""
    memo = _subquery_memo.get()
    pc = current_partial()
    hit = memo.get(id(e)) if memo is not None else None
    if hit is not None and hit[0] is e:
        segments, rows, segments_seen, rows_seen = hit[2]
        if pc is not None:
            pc.add_scope(segments, rows)
            pc.add_seen(segments_seen, rows_seen)
        return hit[1]
    before = _collector_counts(pc)
    inner = execute_fallback(_inner_plan(e), catalog)
    if memo is not None and (pc is None or not pc.triggered):
        counts = tuple(a - b for a, b in zip(_collector_counts(pc), before))
        memo[id(e)] = (e, inner, counts)
    return inner


def _resolve_subqueries(e, catalog, bool_ctx: bool = False):
    """Replace uncorrelated subquery nodes with values.

    An IN subquery whose result holds a NULL becomes `(x IN S) OR NULL` in
    the boolean skeleton of a filter (`bool_ctx`, which the Kleene
    evaluator owns): TRUE for members, UNKNOWN for the rest.  In value
    positions it stays the plain InExpr.  A NULL scalar subquery becomes
    `_SubqNull`, so comparisons against it are UNKNOWN."""
    if isinstance(e, (E.InSubquery, E.ExistsSubquery, E.ScalarSubquery)) and getattr(
        e, "outer_refs", None
    ):
        return e  # correlated: `_materialize_correlated` evaluates it per row
    if isinstance(e, E.InSubquery):
        inner = _subquery_frame(e, catalog)
        _one_column(inner, "IN")
        col = inner.iloc[:, 0]
        base = E.InExpr(_resolve_subqueries(e.operand, catalog), tuple(pd.unique(col.dropna())))
        if bool(col.isna().any()) and bool_ctx:
            return E.BoolOp("or", (base, _SubqNull(None)))
        return base
    if isinstance(e, E.ExistsSubquery):
        return E.Literal(bool(len(_subquery_frame(e, catalog))))
    if isinstance(e, E.ScalarSubquery):
        inner = _subquery_frame(e, catalog)
        _one_column(inner, "scalar")
        if len(inner) > 1:
            raise ValueError(f"scalar subquery produced {len(inner)} rows")
        if not len(inner) or pd.isna(inner.iloc[0, 0]):
            return _SubqNull(None)
        return E.Literal(_scalar_value(inner.iloc[0, 0]))
    if not isinstance(e, Expr):
        return e
    # the boolean context survives only through BoolOp
    child_ctx = bool_ctx and isinstance(e, E.BoolOp)
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            kw[f.name] = _resolve_subqueries(v, catalog, child_ctx)
        elif isinstance(v, tuple) and v and isinstance(v[0], Expr):
            kw[f.name] = tuple(_resolve_subqueries(x, catalog, child_ctx) for x in v)
    return dataclasses.replace(e, **kw) if kw else e


def _substitute_outer(stmt, binding):
    """A correlated subquery's statement with its outer references bound
    to literals (`_SubqNull` for a NULL binding)."""

    def conv(v):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return _SubqNull(None)
        if isinstance(v, np.str_):
            v = str(v)
        return E.Literal(_scalar_value(v))

    def sub_e(e):
        return map_expr(
            e, lambda x: conv(binding[x.name]) if isinstance(x, E.Col) and x.name in binding else x
        )

    return dataclasses.replace(
        stmt,
        items=[(n, sub_e(e)) for n, e in stmt.items],
        where=sub_e(stmt.where) if stmt.where is not None else None,
        having=sub_e(stmt.having) if stmt.having is not None else None,
        group_by=[sub_e(e) for e in stmt.group_by],
        order_by=[(sub_e(e), a) for e, a in stmt.order_by],
    )


def _broadcast_rows(vals, n: int) -> np.ndarray:
    """A constant operand (`10 IN (SELECT ...)`) evaluates 0-d: broadcast."""
    a = np.asarray(vals)
    if a.ndim == 0:
        return np.full(n, a[()], dtype=object)
    return a


def _expr_has_outer(e, refs: set) -> bool:
    return E.any_node(e, lambda x: isinstance(x, E.Col) and x.name in refs)


def _expr_has_subquery(e) -> bool:
    return E.any_node(
        e, lambda x: isinstance(x, (E.InSubquery, E.ScalarSubquery, E.ExistsSubquery))
    )


def _conjuncts(e):
    if isinstance(e, E.BoolOp) and e.op == "and":
        return [c for o in e.operands for c in _conjuncts(o)]
    return [e]


def _try_decorrelate_fill(sub, df, catalog, refs, out) -> bool:
    """Single-pass decorrelation of the common shape, where every outer
    reference appears only in top-level equality conjuncts `inner_col =
    o.outer_col` of the subquery's WHERE: ONE grouped execution over the
    inner table, joined back by key (an order-preserving left merge).
    Fills `out` and returns True; False when the shape does not qualify
    (the per-binding loop of `_correlated_column` then answers)."""
    from ..sql.parser import _contains_agg

    stmt = sub.stmt
    refset = set(refs)
    if stmt.limit is not None or stmt.offset or stmt.distinct:
        return False
    if stmt.group_by or stmt.grouping_sets or stmt.having is not None:
        return False
    if any(isinstance(e, E.Col) and e.name == "*" for _, e in stmt.items):
        return False  # SELECT *: the Analyzer would discard synthetic items
    exprs = [e for _, e in stmt.items] + ([stmt.where] if stmt.where is not None else [])
    if any(_expr_has_subquery(e) for e in exprs):
        return False
    if any(_expr_has_outer(e, refset) for _, e in stmt.items):
        return False
    if any(_expr_has_outer(e, refset) or _expr_has_subquery(e) for e, _ in stmt.order_by):
        return False

    eq_pairs, residual, used = [], [], set()  # eq_pairs: (inner col, outer ref)
    for c in _conjuncts(stmt.where) if stmt.where is not None else []:
        pair = None
        if isinstance(c, E.Comparison) and c.op == "==":
            for a, b in ((c.left, c.right), (c.right, c.left)):
                if (isinstance(a, E.Col) and a.name in refset and isinstance(b, E.Col)
                        and b.name not in refset and "." not in b.name):
                    pair = (b.name, a.name)
                    break
        if pair is not None:
            if pair not in eq_pairs:
                eq_pairs.append(pair)
            used.add(pair[1])
            continue
        if _expr_has_outer(c, refset):
            return False  # an outer reference outside the equality form
        residual.append(c)
    if not eq_pairs or used != refset:
        return False

    has_agg_item = any(_contains_agg(e) for _, e in stmt.items)
    if isinstance(sub, (E.ExistsSubquery, E.InSubquery)) and has_agg_item:
        return False  # an aggregate subquery yields one row whatever matches
    if isinstance(sub, E.ScalarSubquery) and not has_agg_item:
        return False  # the per-binding >1-row check must stay exact

    res_where = None
    for c in residual:
        res_where = c if res_where is None else E.BoolOp("and", (res_where, c))
    key_cols = [ic for ic, _ in eq_pairs]
    key_names = [f"__dk{i}" for i in range(len(eq_pairs))]
    ocols = [np.asarray(df[q.split(".", 1)[1]]) for _, q in eq_pairs]
    onull = np.zeros(len(df), dtype=bool)
    for c in ocols:
        onull |= np.asarray(pd.isna(c))
    okf = pd.DataFrame(dict(zip(key_names, ocols)), copy=False)
    key_items = [(n, E.Col(ic)) for n, ic in zip(key_names, key_cols)]

    if isinstance(sub, E.ExistsSubquery):
        stmt2 = dataclasses.replace(stmt, items=key_items, where=res_where,
                                    group_by=[E.Col(ic) for ic in key_cols], order_by=[])
        inner = execute_fallback(_inner_plan(sub, stmt2), catalog)
        kf = inner[key_names]
        m = okf.merge(kf[~kf.isna().any(axis=1)].drop_duplicates(), on=key_names,
                      how="left", indicator=True)
        out[:] = (m["_merge"].to_numpy() == "both") & ~onull
        return True

    if isinstance(sub, E.InSubquery):
        if len(stmt.items) != 1:
            return False
        stmt2 = dataclasses.replace(stmt, items=key_items + [("__dv", stmt.items[0][1])],
                                    where=res_where, order_by=[])
        inner = execute_fallback(_inner_plan(sub, stmt2), catalog)
        ok = ~inner[key_names].isna().any(axis=1)
        op_vals = _broadcast_rows(_eval(sub.operand, df), len(df))
        op_null = np.asarray(pd.isna(op_vals))
        inner_ok = inner[ok]
        dv_null = inner_ok["__dv"].isna()
        # per key: does its value set hold a NULL, does it hold anything
        per_key = (
            pd.DataFrame({**{n: inner_ok[n] for n in key_names},
                          "__hasnull": dv_null.to_numpy(),
                          "__nvals": (~dv_null).to_numpy().astype(np.int64)})
            .groupby(key_names, as_index=False, dropna=False)
            .agg(__hasnull=("__hasnull", "any"), __nvals=("__nvals", "sum"))
        )
        m = okf.merge(per_key, on=key_names, how="left")
        key_has_null = m["__hasnull"].fillna(False).to_numpy(dtype=bool) & ~onull
        key_has_vals = (m["__nvals"].fillna(0).to_numpy() > 0) & ~onull
        # a direct (key, value) hit; merge treats NaN as equal, so NULL
        # values and operands are excluded
        nn = ~dv_null.to_numpy()
        iv = pd.DataFrame({**{n: inner_ok[n][nn] for n in key_names},
                           "__op": inner_ok["__dv"][nn]}).drop_duplicates()
        mh = okf.assign(__op=op_vals).merge(iv, on=key_names + ["__op"], how="left",
                                            indicator=True)
        direct_hit = (mh["_merge"].to_numpy() == "both") & ~op_null & ~onull
        res = np.empty(len(df), dtype=object)
        res[:] = False
        empty_set = ~key_has_vals & ~key_has_null
        res[(key_has_null | op_null) & ~empty_set & ~direct_hit] = None
        res[direct_hit] = True
        out[:] = res
        return True

    # a scalar subquery with an aggregate item: the aggregate grouped by the
    # keys; an absent key takes the aggregate over zero rows (COUNT 0,
    # others NULL), measured by running the ungrouped statement over none
    if len(stmt.items) != 1:
        return False
    stmt2 = dataclasses.replace(stmt, items=key_items + [("__dv", stmt.items[0][1])],
                                where=res_where, group_by=[E.Col(ic) for ic in key_cols],
                                order_by=[])
    inner = execute_fallback(_inner_plan(sub, stmt2), catalog)
    false_where = E.Literal(False)
    if res_where is not None:
        false_where = E.BoolOp("and", (res_where, false_where))
    empty = execute_fallback(
        _inner_plan(sub, dataclasses.replace(stmt, where=false_where, order_by=[])), catalog)
    neutral = empty.iloc[0, 0] if len(empty) else None
    if neutral is not None and pd.isna(neutral):
        neutral = None
    ok = ~inner[key_names].isna().any(axis=1)
    m = okf.merge(inner[ok][key_names + ["__dv"]].drop_duplicates(key_names),
                  on=key_names, how="left", indicator=True)
    matched = (m["_merge"].to_numpy() == "both") & ~onull
    vals = np.array(m["__dv"], dtype=object)
    vals[pd.isna(vals)] = None  # an aggregated NULL stays None
    res = np.full(len(df), neutral, dtype=object)
    res[matched] = vals[matched]
    out[:] = res
    return True


def _correlated_column(sub, df: pd.DataFrame, catalog) -> pd.Series:
    """A correlated subquery's value for every row of the outer frame: the
    single-pass decorrelation where it applies, else one execution per
    DISTINCT binding of the outer references, joined back by position.
    InSubquery gives object True/False/None (None = UNKNOWN), ExistsSubquery
    bool, ScalarSubquery the scalar (None = NULL)."""
    refs = list(sub.outer_refs)
    bare = [q.split(".", 1)[1] for q in refs]
    missing = [b for b in bare if b not in df.columns]
    if missing:
        raise KeyError(
            f"correlated subquery references outer columns {missing} "
            "not present in the outer frame"
        )
    out = np.empty(len(df), dtype=object)
    if _try_decorrelate_fill(sub, df, catalog, refs, out):
        return _correlated_series(sub, out, df)
    if isinstance(sub, E.InSubquery):
        op_vals = _broadcast_rows(_eval(sub.operand, df), len(df))
        op_null = np.asarray(pd.isna(op_vals))
    for key, ilocs in df.groupby(bare, dropna=False).indices.items():
        tup = key if isinstance(key, tuple) else (key,)
        binding = {q: (None if pd.isna(v) else v) for q, v in zip(refs, tup)}
        stmt2 = _substitute_outer(sub.stmt, binding)
        if isinstance(sub, E.ExistsSubquery) and stmt2.limit is None and not stmt2.offset:
            # existence needs the first row; a written LIMIT/OFFSET is kept
            stmt2 = dataclasses.replace(stmt2, limit=1, offset=0)
        inner = execute_fallback(_inner_plan(sub, stmt2), catalog)
        if isinstance(sub, E.ExistsSubquery):
            out[ilocs] = bool(len(inner))
        elif isinstance(sub, E.ScalarSubquery):
            _one_column(inner, "scalar")
            if len(inner) > 1:
                raise ValueError(f"scalar subquery produced {len(inner)} rows")
            v = inner.iloc[0, 0] if len(inner) else None
            out[ilocs] = None if v is not None and pd.isna(v) else v
        else:
            _one_column(inner, "IN")
            col = inner.iloc[:, 0]
            vals = set(pd.unique(col.dropna()))
            has_null = bool(col.isna().any())
            for i in ilocs:
                if not op_null[i] and op_vals[i] in vals:
                    out[i] = True
                elif not vals and not has_null:
                    out[i] = False  # IN over an EMPTY set is FALSE, even NULL
                elif has_null or op_null[i]:
                    out[i] = None
                else:
                    out[i] = False
    return _correlated_series(sub, out, df)


def _correlated_series(sub, out, df) -> pd.Series:
    """The per-row values as a Series; a scalar subquery's numbers become
    float64 (None -> NaN) where that is exact: all NULL, or numbers with
    every integer below 2^53 in magnitude."""
    ser = pd.Series(out, index=df.index)
    if not isinstance(sub, E.ScalarSubquery):
        return ser
    kind = pd.api.types.infer_dtype(out, skipna=True)
    if kind in ("empty", "floating"):
        return ser.astype(np.float64)
    if kind == "integer":
        ints = np.asarray(out[pd.notna(out)], dtype=np.float64)
        return ser if (np.abs(ints) >= 2.0 ** 53).any() else ser.astype(np.float64)
    nn = [v for v in out if v is not None]
    if all(isinstance(v, (int, float, np.number)) for v in nn) and all(
        isinstance(v, (float, np.floating)) or abs(int(v)) < (1 << 53) for v in nn
    ):
        return ser.astype(np.float64)
    return ser


_CSQ_IDS = itertools.count()  # process-unique temp column names


def _materialize_correlated(e, df: pd.DataFrame, catalog):
    """Replace every correlated subquery of an expression with a Col over a
    temp per-row column (`_correlated_column`); returns (expression, frame
    with the temp columns)."""
    if not isinstance(e, Expr):
        return e, df
    added = {}

    def repl(x):
        if isinstance(x, (E.InSubquery, E.ExistsSubquery, E.ScalarSubquery)) and getattr(
            x, "outer_refs", None
        ):
            # unique across calls: the Aggregate branch materializes several
            # expressions into one accumulated frame
            name = f"__csq{next(_CSQ_IDS)}"
            added[name] = _correlated_column(x, df, catalog)
            return E.Col(name)
        return x

    e2 = map_expr(e, repl)
    if not added:
        return e, df
    df2 = df.copy(deep=False)
    for k, v in added.items():
        df2[k] = v
    return e2, df2


def _resolve_plan_subqueries(lp: L.LogicalPlan, catalog) -> L.LogicalPlan:
    """Resolve the uncorrelated subqueries of every expression of a plan."""

    def rx(e):
        return _resolve_subqueries(e, catalog) if e is not None else None

    def rx_bool(e):
        # Filter/Having conditions and FILTER clauses: the Kleene skeleton
        return _resolve_subqueries(e, catalog, bool_ctx=True) if e is not None else None

    def down(x):
        return _resolve_plan_subqueries(x, catalog)

    if isinstance(lp, L.Filter):
        return L.Filter(rx_bool(lp.condition), down(lp.child))
    if isinstance(lp, L.Having):
        return L.Having(rx_bool(lp.condition), down(lp.child))
    if isinstance(lp, L.Project):
        return L.Project(tuple((n, rx(e)) for n, e in lp.exprs), down(lp.child))
    if isinstance(lp, L.Aggregate):
        return dataclasses.replace(
            lp,
            group_exprs=tuple((n, rx(e)) for n, e in lp.group_exprs),
            agg_exprs=tuple(dataclasses.replace(ae, arg=rx(ae.arg), filter=rx_bool(ae.filter))
                            for ae in lp.agg_exprs),
            post_exprs=tuple((n, rx(e)) for n, e in lp.post_exprs),
            child=down(lp.child),
        )
    if isinstance(lp, L.Sort):
        return L.Sort(tuple(dataclasses.replace(k, expr=rx(k.expr)) for k in lp.keys),
                      down(lp.child))
    if isinstance(lp, L.Window):
        return dataclasses.replace(
            lp,
            wins=tuple(
                dataclasses.replace(
                    w, arg=rx(w.arg), filter=rx_bool(w.filter),
                    partition=tuple(rx(p) for p in w.partition),
                    order_exprs=tuple(rx(o) for o in w.order_exprs),
                )
                for w in lp.wins
            ),
            out_exprs=tuple((n, rx(e)) for n, e in lp.out_exprs),
            child=down(lp.child),
        )
    if isinstance(lp, (L.Limit, L.SubqueryScan)):
        return dataclasses.replace(lp, child=down(lp.child))
    if isinstance(lp, L.Union):
        return dataclasses.replace(lp, branches=tuple(down(b) for b in lp.branches))
    if isinstance(lp, L.Join):
        return dataclasses.replace(lp, left=down(lp.left), right=down(lp.right))
    return lp


def _project_root(df: pd.DataFrame, lp: L.LogicalPlan) -> pd.DataFrame:
    """Project an interpreted frame to the plan's SELECT list."""
    sel = _select_list(lp)
    if sel is None:
        return df.drop(columns=[c for c in df.columns
                                if c.startswith("__agg") or c == "__grouping_id"])
    missing = [c for c in sel if c not in df.columns]
    if missing:
        raise KeyError(f"fallback result is missing SELECT columns {missing}")
    return df[list(sel)]


# -- the entry point ------------------------------------------------------


def plan_tables(lp: L.LogicalPlan) -> set:
    """Every base table a plan scans (derived tables and set-operation
    branches included; subqueries inside expressions are guarded by their
    own `execute_fallback`)."""
    if isinstance(lp, L.Scan):
        return {lp.table}
    out: set = set()
    for f in dataclasses.fields(lp):
        v = getattr(lp, f.name)
        for x in (v if isinstance(v, tuple) else (v,)):
            if isinstance(x, L.LogicalPlan):
                out |= plan_tables(x)
    return out


def plan_input_rows(lp: L.LogicalPlan, catalog) -> int:
    """The summed rows of the base tables a plan scans: the size guard's
    measure, and the device assist's."""
    return sum(ds.num_rows for ds in map(catalog.get, plan_tables(lp)) if ds is not None)


class FallbackSizeError(ValueError):
    """The fallback's input exceeds SessionConfig.fallback_max_rows."""


# the size ceiling and the device-assist hook, inherited by the nested
# execute_fallback calls of subqueries
_guard_max_rows = contextvars.ContextVar("fallback_guard_max_rows", default=0)
_device_exec = contextvars.ContextVar("fallback_device_exec", default=None)


def execute_fallback(lp: L.LogicalPlan, catalog, max_rows: int = 0,
                     device_exec=None) -> pd.DataFrame:
    """Interpret a logical plan over decoded host frames, projected to the
    plan's SELECT list.

    `max_rows` > 0 refuses an input of more base rows (FallbackSizeError);
    nested subquery executions inherit the ceiling.

    `device_exec(aggregate_plan) -> DataFrame | None` is the device-assist
    hook: every Aggregate subtree is offered to it before it is
    interpreted here; None means it declined, and the host interprets."""
    limit = max_rows or _guard_max_rows.get()
    if limit:
        rows_in = plan_input_rows(lp, catalog)
        if rows_in > limit:
            raise FallbackSizeError(
                f"host-fallback input is {rows_in:,} rows across "
                f"{sorted(plan_tables(lp))}, above the fallback_max_rows ceiling "
                f"of {limit:,}.  This query could not be rewritten to the "
                "accelerated engine; restructure it (a conforming star join, "
                "supported predicates) or raise the ceiling with SET fallback_max_rows."
            )
    token = _guard_max_rows.set(limit)
    dev_token = _device_exec.set(device_exec) if device_exec is not None else None
    try:
        lp = _resolve_plan_subqueries(lp, catalog)
        return _project_root(_exec(lp, catalog, _pruned_columns(lp)), lp).reset_index(drop=True)
    finally:
        _guard_max_rows.reset(token)
        if dev_token is not None:
            _device_exec.reset(dev_token)


# -- set operations -------------------------------------------------------


class _Null:
    """SQL NULL inside set-operation row keys: set operations treat NULLs
    as equal, and None / NaN / NaT would not hash equal."""

    __slots__ = ()

    def __repr__(self):
        return "<null>"


_NULL = _Null()


def _row_keys(df: pd.DataFrame) -> list:
    arr = df.to_numpy(dtype=object)
    na = pd.isna(arr)
    return [
        tuple(_NULL if na[i, j] else arr[i, j] for j in range(arr.shape[1]))
        for i in range(arr.shape[0])
    ]


def _setop(op: str, frames: list) -> pd.DataFrame:
    """SQL set operations over positionally aligned frames.  Distinct
    variants keep the first occurrence of a row; ALL variants are bag
    algebra (INTERSECT ALL: the least multiplicity; EXCEPT ALL: left minus
    right)."""
    if op == "union_all":
        return pd.concat(frames, ignore_index=True)
    if op == "union":
        cat = pd.concat(frames, ignore_index=True)
        seen, keep = set(), []
        for i, k in enumerate(_row_keys(cat)):
            if k not in seen:
                seen.add(k)
                keep.append(i)
        return cat.iloc[keep].reset_index(drop=True)
    left = frames[0]
    lkeys = _row_keys(left)
    rkey_counts = [Counter(_row_keys(f)) for f in frames[1:]]
    if op in ("intersect", "intersect_all"):
        budget: dict = {}
        for k in set(lkeys):
            m = min(c[k] for c in rkey_counts)
            if m:
                budget[k] = 1 if op == "intersect" else m
    elif op in ("except", "except_all"):
        rc = rkey_counts[0]
        if op == "except":
            budget = {k: 1 for k in set(lkeys) if rc[k] == 0}
        else:
            budget = {k: n - rc[k] for k, n in Counter(lkeys).items() if n - rc[k] > 0}
    else:
        raise NotImplementedError(f"set operation {op!r}")
    keep = []  # a budget of 1 also removes duplicates on the left
    for i, k in enumerate(lkeys):
        b = budget.get(k, 0)
        if b:
            budget[k] = b - 1
            keep.append(i)
    return left.iloc[keep].reset_index(drop=True)


# -- windows --------------------------------------------------------------


def _sort_codes(v: np.ndarray, ascending: bool) -> np.ndarray:
    """One sort key as int64 codes, NULLs last, honoring `ascending`."""
    codes, uniques = pd.factorize(pd.Series(v), sort=True)
    k = len(uniques)
    if not ascending:
        codes = np.where(codes >= 0, k - 1 - codes, codes)
    return np.where(codes < 0, k, codes).astype(np.int64)


def _window_order(w: L.WindowExpr, df: pd.DataFrame, pid: np.ndarray):
    """Evaluation order (partition-major, then the ORDER BY keys) and the
    [n, m] code matrix whose row equality defines peers."""
    n = len(df)
    if not w.order_exprs:
        return np.argsort(pid, kind="stable"), None
    keys = [_sort_codes(np.asarray(_eval(_refs_to_cols(oe), df)), asc)
            for oe, asc in zip(w.order_exprs, w.order_asc)]
    # np.lexsort: the LAST key is primary
    order = np.lexsort(tuple([np.arange(n)] + keys[::-1] + [pid]))
    return order, np.stack(keys, axis=1)


def _window_col(w: L.WindowExpr, df: pd.DataFrame) -> np.ndarray:
    """One window function over the frame, partition by partition."""
    n = len(df)
    res = np.empty(n, dtype=object)
    if n == 0:
        return res
    if w.partition:
        pcols = [np.asarray(_eval(_refs_to_cols(p), df)) for p in w.partition]
        ids: dict = {}
        pid = np.empty(n, dtype=np.int64)
        for i in range(n):
            key = tuple(_NULL if pd.isna(c[i]) else c[i] for c in pcols)
            pid[i] = ids.setdefault(key, len(ids))
    else:
        pid = np.zeros(n, dtype=np.int64)
    order, peer_codes = _window_order(w, df, pid)
    va = np.asarray(_eval(_refs_to_cols(w.arg), df)) if w.arg is not None else None
    fm = (np.asarray(_filter_mask(w.filter, df)).astype(bool)
          if w.filter is not None else None)
    pid_sorted = pid[order]
    starts = [0] + [i for i in range(1, n) if pid_sorted[i] != pid_sorted[i - 1]] + [n]
    for a, b in zip(starts[:-1], starts[1:]):
        _window_partition(w, order[a:b], peer_codes, va, fm, res)
    return res


def _window_partition(w, idxs, peer_codes, va, fm, res):
    """Fill `res` for one partition (`idxs`: row positions in window
    order)."""
    m = len(idxs)
    fn = w.fn
    if peer_codes is not None:
        pk = peer_codes[idxs]
        new_peer = np.empty(m, dtype=bool)
        new_peer[0] = True
        if m > 1:
            new_peer[1:] = (pk[1:] != pk[:-1]).any(axis=1)
        peer_id = np.cumsum(new_peer) - 1
        peer_start = np.maximum.accumulate(np.where(new_peer, np.arange(m), 0))
        peer_end = np.empty(m, dtype=np.int64)  # inclusive end of the peers
        last = m - 1
        for i in range(m - 1, -1, -1):
            peer_end[i] = last
            if new_peer[i]:
                last = i - 1
    else:
        peer_id = np.zeros(m, dtype=np.int64)
        peer_start = np.zeros(m, dtype=np.int64)
        peer_end = np.full(m, m - 1, dtype=np.int64)

    if fn == "row_number":
        for i in range(m):
            res[idxs[i]] = i + 1
        return
    if fn == "rank":
        for i in range(m):
            res[idxs[i]] = int(peer_start[i]) + 1
        return
    if fn == "dense_rank":
        for i in range(m):
            res[idxs[i]] = int(peer_id[i]) + 1
        return
    if fn == "percent_rank":
        for i in range(m):
            res[idxs[i]] = 0.0 if m == 1 else float(peer_start[i]) / (m - 1)
        return
    if fn == "cume_dist":
        for i in range(m):
            res[idxs[i]] = float(peer_end[i] + 1) / m
        return
    if fn == "ntile":
        k = int(w.args[0])
        base, rem = divmod(m, k)
        bucket_of = []
        for bi in range(k):
            bucket_of += [bi + 1] * (base + (1 if bi < rem else 0))
        for i in range(m):
            res[idxs[i]] = bucket_of[i] if i < len(bucket_of) else k
        return
    if fn in ("lag", "lead"):
        off = int(w.args[0]) if w.args else 1
        default = w.args[1] if len(w.args) > 1 else None
        vp = va[idxs]
        for i in range(m):
            j = i - off if fn == "lag" else i + off
            if 0 <= j < m:
                res[idxs[i]] = None if pd.isna(vp[j]) else vp[j]
            else:
                res[idxs[i]] = default
        return

    def frame_bounds(i):
        if w.frame is not None:
            lo, hi = w.frame
            return (0 if lo is None else max(0, i + lo),
                    m - 1 if hi is None else min(m - 1, i + hi))
        if peer_codes is not None:
            # the default frame with ORDER BY: RANGE UNBOUNDED PRECEDING ..
            # CURRENT ROW, the current row's peers included
            return 0, int(peer_end[i])
        return 0, m - 1

    vp = va[idxs] if va is not None else None
    fmp = fm[idxs] if fm is not None else None

    if fn in ("first_value", "last_value", "nth_value"):
        nth = int(w.args[0]) if fn == "nth_value" else 1
        for i in range(m):
            lo_i, hi_i = frame_bounds(i)
            j = hi_i if fn == "last_value" else lo_i + nth - 1
            if lo_i > hi_i or j > hi_i:
                res[idxs[i]] = None
                continue
            res[idxs[i]] = None if pd.isna(vp[j]) else vp[j]
        return

    # aggregates over the default frames: one running pass
    if fn in ("sum", "count", "avg", "min", "max") and w.frame is None:
        run_sum, run_cnt, n_rows = 0.0, 0, 0
        run_min = run_max = None
        pref = [None] * m
        for i in range(m):
            if fmp is None or fmp[i]:
                n_rows += 1
                if vp is not None and not pd.isna(vp[i]):
                    v = vp[i]
                    run_cnt += 1
                    if fn in ("sum", "avg"):
                        run_sum += float(v)
                    elif fn == "min" and (run_min is None or v < run_min):
                        run_min = v
                    elif fn == "max" and (run_max is None or v > run_max):
                        run_max = v
            if fn == "count":
                pref[i] = n_rows if vp is None else run_cnt
            elif fn == "sum":
                pref[i] = run_sum if run_cnt else None
            elif fn == "avg":
                pref[i] = run_sum / run_cnt if run_cnt else None
            else:
                pref[i] = run_min if fn == "min" else run_max
        # without ORDER BY peer_end is m - 1: the whole-partition aggregate
        for i in range(m):
            res[idxs[i]] = pref[int(peer_end[i])]
        return

    for i in range(m):  # explicit ROWS frames
        lo_i, hi_i = frame_bounds(i)
        if lo_i > hi_i:
            res[idxs[i]] = 0 if fn == "count" else None
            continue
        sl = slice(lo_i, hi_i + 1)
        rows = np.ones(hi_i - lo_i + 1, dtype=bool)
        if fmp is not None:
            rows &= fmp[sl]
        if fn == "count" and vp is None:
            res[idxs[i]] = int(rows.sum())
            continue
        vals = vp[sl][rows]
        vals = vals[~pd.isna(vals)]
        if fn == "count":
            res[idxs[i]] = int(len(vals))
        elif len(vals) == 0:
            res[idxs[i]] = None
        elif fn == "min":
            res[idxs[i]] = min(vals)  # strings too
        elif fn == "max":
            res[idxs[i]] = max(vals)
        elif fn == "sum":
            res[idxs[i]] = float(vals.astype(np.float64).sum())
        elif fn == "avg":
            res[idxs[i]] = float(vals.astype(np.float64).mean())
        else:
            raise NotImplementedError(f"window function {fn!r}")


# -- the plan walk --------------------------------------------------------

# decoded scan frames above this row count are not cached
_FRAME_CACHE_MAX_ROWS = 5_000_000


def _cached_scan_frame(catalog, table: str, needed) -> pd.DataFrame:
    """The decoded frame of a table from a small per-catalog LRU, keyed on
    the catalog version.  Consumers only add columns (a shallow copy shares
    the arrays)."""
    ds = catalog.get(table)
    if ds is None:
        raise KeyError(f"unknown table {table!r}")
    if site_armed("fallback_decode"):
        # an injected decode fault is neither masked by a cached frame nor
        # left in the cache for later healthy queries
        return decoded_frame(ds, columns=needed)
    cache = getattr(catalog, "_fallback_frames", None)
    if cache is None:
        cache = catalog._fallback_frames = CountBudgetCache(4)
    key = (table, catalog.version, frozenset(needed) if needed is not None else None)
    pc = current_partial()
    df = cache.get(key)
    if df is None:
        df = decoded_frame(ds, columns=needed)
        # a frame a deadline truncated never enters the cache
        if len(df) <= _FRAME_CACHE_MAX_ROWS and (pc is None or not pc.triggered):
            cache[key] = df
    elif pc is not None:
        # a hit saw the whole table without a decode
        segs = list(ds.segments)
        rows = row_counts(segs)
        pc.add_scope(len(segs), *rows)
        pc.add_seen(len(segs), *rows)
    return df.copy(deep=False)


def _exec(lp: L.LogicalPlan, catalog, _needed=None) -> pd.DataFrame:
    """Interpret a logical plan over decoded host frames, a checkpoint
    before each plan node (`fallback.interp`)."""
    checkpoint("fallback.interp")
    if isinstance(lp, L.Scan):
        return _cached_scan_frame(catalog, lp.table, _needed)
    if isinstance(lp, L.Filter):
        df = _exec(lp.child, catalog, _needed)
        if not len(df):
            return df
        cond, dfx = _materialize_correlated(lp.condition, df, catalog)
        return _apply_mask(df, _filter_mask(cond, dfx))
    if isinstance(lp, L.Project):
        df = _exec(lp.child, catalog, _needed)

        def proj(e):
            e2, dfx = _materialize_correlated(e, df, catalog)
            return _eval(e2, dfx)

        return pd.DataFrame({name: proj(e) for name, e in lp.exprs}, index=df.index)
    if isinstance(lp, L.Join):
        # a star-conforming join collapses onto the flat fact, as the
        # planner's join transform does: the flat fact may not even carry
        # the foreign keys the textual join names
        from ..catalog.star import try_collapse_join

        collapsed = try_collapse_join(lp, catalog)
        if collapsed is not None:
            return _exec(collapsed, catalog, _needed)
        out = _exec(lp.left, catalog, _needed).merge(
            _exec(lp.right, catalog, _needed),
            left_on=list(lp.left_keys), right_on=list(lp.right_keys), how=lp.how,
            # a non-key name on both sides keeps the LEFT column; the right
            # duplicate is unreachable by any expression and is dropped
            suffixes=("", "__joindup"),
        )
        dup = [c for c in out.columns if c.endswith("__joindup")]
        return out.drop(columns=dup) if dup else out
    if isinstance(lp, L.Union):
        # each branch projects to its own SELECT list, then aligns to the
        # first branch's names
        frames = [_project_root(_exec(b, catalog, _pruned_columns(b)), b) for b in lp.branches]
        first = frames[0].columns
        aligned = [frames[0]]
        for f in frames[1:]:
            if len(f.columns) != len(first):
                raise ValueError(
                    f"{lp.op} branch produced {len(f.columns)} columns, expected {len(first)}")
            aligned.append(f.set_axis(list(first), axis=1))
        return _setop(lp.op, aligned)
    if isinstance(lp, L.SubqueryScan):
        # a scope boundary: the derived table exports exactly its SELECT list
        df = _exec(lp.child, catalog, _pruned_columns(lp.child))
        if lp.columns is not None:
            missing = [c for c in lp.columns if c not in df.columns]
            if missing:
                raise KeyError(
                    f"derived table {lp.alias or '(subquery)'} does not produce columns {missing}")
            df = df[list(lp.columns)]
        return df
    if isinstance(lp, L.Aggregate):
        dev = _device_exec.get()
        if dev is not None:
            out = dev(lp)
            if out is not None:
                return out
        df = _exec(lp.child, catalog, _needed)

        # correlated subqueries in group expressions, aggregate arguments
        # and FILTER clauses bind per row before grouping
        def mat(e):
            nonlocal df
            if e is None:
                return None
            e2, df = _materialize_correlated(e, df, catalog)
            return e2

        groups = tuple((n, mat(e)) for n, e in lp.group_exprs)
        aggs = tuple(dataclasses.replace(ae, arg=mat(ae.arg), filter=mat(ae.filter))
                     for ae in lp.agg_exprs)
        if (groups, aggs) != (lp.group_exprs, lp.agg_exprs):
            lp = dataclasses.replace(lp, group_exprs=groups, agg_exprs=aggs)
        return _aggregate(lp, df)
    if isinstance(lp, L.Window):
        df = _exec(lp.child, catalog, _needed).copy()
        for w in lp.wins:
            df[w.name] = _window_col(w, df)
        # every output evaluates over the unmodified frame first: an alias
        # shadowing a source column (v + 1 AS v) must not change later items
        new_cols = {}
        for name, e in lp.out_exprs:
            if isinstance(e, E.Col) and e.name in df.columns:
                new_cols[name] = df[e.name]
                continue
            e2, dfx = _materialize_correlated(_refs_to_cols(e), df, catalog)
            new_cols[name] = _eval(e2, dfx)
        for name, v in new_cols.items():
            df[name] = v
        return df
    if isinstance(lp, L.Having):
        df = _exec(lp.child, catalog, _needed)
        if not len(df):
            return df
        cond, dfx = _materialize_correlated(_refs_to_cols(lp.condition), df, catalog)
        return _apply_mask(df, _filter_mask(cond, dfx))
    if isinstance(lp, L.Sort):
        df = _exec(lp.child, catalog, _needed)
        if not len(df):
            return df
        tmp = []
        for i, k in enumerate(lp.keys):
            c = f"__sort{i}"
            ke, dfx = _materialize_correlated(_refs_to_cols(k.expr), df, catalog)
            df = df.assign(**{c: _eval(ke, dfx)})
            tmp.append(c)
        df = df.sort_values(tmp, ascending=[k.ascending for k in lp.keys], kind="stable",
                            na_position="last")
        return df.drop(columns=tmp)
    if isinstance(lp, L.Limit):
        df = _exec(lp.child, catalog, _needed)
        return df.iloc[lp.offset: lp.offset + lp.n]
    raise NotImplementedError(f"fallback execution for {type(lp).__name__}")
