"""Planner: drives the rewrite rules over a logical plan.

Folds the transforms over the logical plan, threading an immutable
`QueryBuilder`; the surviving builder picks the most specific query type
(Timeseries, TopN, GroupBy).  Plans that cannot be rewritten raise
`RewriteError` with the reason (surfaced by `explain`, the `EXPLAIN DRUID
REWRITE` analog).  Under `count_distinct_mode = 'exact'` a COUNT(DISTINCT x)
plans in two phases: an inner grouping by the query's dimensions and x (a
high-cardinality group-by, which the engine's tiers carry) and a host
re-aggregation (`ExactDistinctOuter`, run by `api`).  A non-aggregate plan
becomes a Scan query (`is_scan`).  There is no cost model: the engine
picks the group-by path from the group count, and `explain` prints the
paths it tries.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from ..catalog.segment import DataSource
from ..config import SessionConfig
from ..models import query as Q
from ..utils.log import get_logger
from . import expr as E
from . import logical as L
from .builder import QueryBuilder
from .cost import PhysicalPlan, choose_physical
from .transforms import (
    RewriteError,
    RewritePolicyError,
    apply_sort_limit,
    substitute,
    translate_aggregate,
    translate_filter,
    translate_group_expr,
    translate_having,
    translate_post_expr,
)

log = get_logger("plan.planner")


@dataclasses.dataclass
class ExactDistinctOuter:
    """The host re-aggregation of an exact COUNT(DISTINCT) plan
    (count_distinct_mode = 'exact', the reference's pushHLLTODruid = false).
    The inner rewrite groups by (dims..., distinct columns...); the outer
    pass re-aggregates on the host: re-aggregable aggregates fold with
    `outer_ops`, a distinct output counts the unique non-null values of its
    column, an AVG is recomputed from its sum and count parts."""

    inner: "Rewrite"
    dim_names: Tuple[str, ...]  # outer grouping columns
    distinct_outs: Tuple[Tuple[str, str], ...]  # (output name, inner column)
    outer_ops: Tuple[Tuple[str, str], ...]  # (column, "sum"|"min"|"max")
    count_like: Tuple[str, ...]  # columns cast back to int64 after the fold
    avg_div: Tuple[Tuple[str, str, str], ...]  # (name, sum col, count col)
    post_exprs: Tuple[Tuple[str, E.Expr], ...]
    having: Optional[E.Expr]
    sort_keys: Tuple[Tuple[str, bool], ...]  # (column, ascending)
    limit: Optional[int]
    offset: int
    output_columns: Tuple[str, ...]


@dataclasses.dataclass
class Rewrite:
    """The planner's output: query spec + everything the execution layer
    needs to finalize results (the DruidStrategy 'projection fixup' analog)."""

    datasource: str
    builder: QueryBuilder
    query: Q.QuerySpec
    # plan-time estimate of the kernel group-id domain (row-major product
    # of the grouped dimensions' cardinalities); the engine counts exactly
    num_groups: int
    output_columns: Tuple[str, ...]
    dim_names: Tuple[str, ...]
    residual_having: Optional[E.Expr]
    host_post_exprs: Tuple[Tuple[str, E.Expr], ...]
    grouping_sets: Tuple[Tuple[int, ...], ...]
    is_scan: bool = False
    # FD grouping pruning: (output column, hidden dimCodeMax agg, source
    # dimension) triples the API decodes back after execution
    fd_restores: Tuple[Tuple[str, str, str], ...] = ()
    # set for an exact COUNT(DISTINCT) plan: `query` is then the inner
    # grouping and this is its host re-aggregation
    exact_distinct: Optional[ExactDistinctOuter] = None
    # the cost model's decision (`plan/cost.choose_physical`): the kernel
    # class the query runs, on the planner's device
    physical: Optional[PhysicalPlan] = None

    def to_json(self) -> str:
        return json.dumps(self.query.to_druid(), indent=2, default=str)


class Planner:
    def __init__(self, catalog, cfg: Optional[SessionConfig] = None, device=None,
                 n_devices: int = 1):
        self.catalog = catalog  # name -> DataSource (catalog/cache.py)
        self.cfg = cfg or SessionConfig()
        # the executing device: the cost model prices the dense class by
        # its kernel there (None: the CPU's rules)
        self.device = device
        # the shards of the context's device list: above one the cost model
        # may plan the mesh
        self.n_devices = n_devices

    # -- plan walking --------------------------------------------------------

    def plan(self, lp: L.LogicalPlan) -> Rewrite:
        if not self.cfg.enable_rewrites:
            raise RewriteError("rewrites disabled by config")
        if _plan_contains_subquery(lp):
            # semi-joins cannot lower to the row kernel in ANY position
            # (WHERE, HAVING, SELECT expressions, agg FILTERs); reject at
            # PLAN time so the host fallback executes the whole query —
            # a residual would only fail later, mid-execution
            raise RewriteError("subqueries require host fallback execution")
        limit: Optional[int] = None
        offset = 0
        sort_keys: List[L.SortKey] = []
        having_cond: Optional[E.Expr] = None
        top_projections: Optional[Tuple[Tuple[str, E.Expr], ...]] = None

        node = lp
        while True:
            if isinstance(node, L.Limit):
                limit, offset = node.n, node.offset
                node = node.child
            elif isinstance(node, L.Sort):
                sort_keys = list(node.keys)
                node = node.child
            elif isinstance(node, L.Having):
                having_cond = node.condition
                node = node.child
            elif isinstance(node, L.Project) and _contains_aggregate(node.child):
                top_projections = node.exprs
                node = node.child
            else:
                break

        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(
                node, limit, offset, sort_keys, having_cond, top_projections
            )
        # non-aggregate query -> Scan (reference nonAggregateQueryHandling)
        if self.cfg.non_aggregate_query_handling != "scan":
            raise RewriteError("non-aggregate query (scan handling disabled)")
        return self._plan_scan(node, limit, offset, sort_keys, top_projections)

    # -- aggregate path ------------------------------------------------------

    def _collapse_below(
        self, node: L.LogicalPlan
    ) -> Tuple[str, Dict[str, E.Expr], List[E.Expr]]:
        """Walk Filter/Project chain below the Aggregate to the Scan leaf.
        Returns (table, projection env, filter conditions bottom-up).
        Join subtrees are collapsed by the star-schema transform
        (plan/star_join.py) before this walk."""
        env: Dict[str, E.Expr] = {}
        filters: List[E.Expr] = []
        while True:
            if isinstance(node, L.Scan):
                return node.table, env, filters
            if isinstance(node, L.Filter):
                filters.append(substitute(node.condition, env))
                node = node.child
                continue
            if isinstance(node, L.Project):
                for name, e in node.exprs:
                    env[name] = substitute(e, env)
                node = node.child
                continue
            if isinstance(node, L.Join):
                from .star_join import collapse_star_join

                node = collapse_star_join(node, self.catalog, self.cfg)
                continue
            raise RewriteError(
                f"cannot rewrite plan node {type(node).__name__} under Aggregate"
            )

    def _plan_aggregate(
        self,
        agg: L.Aggregate,
        limit: Optional[int],
        offset: int,
        sort_keys: List[L.SortKey],
        having_cond: Optional[E.Expr],
        top_projections,
    ) -> Rewrite:
        if self.cfg.count_distinct_mode == "exact" and any(
            _is_count_distinct(ae) for ae in agg.agg_exprs
        ):
            return self._plan_exact_distinct(
                agg, limit, offset, sort_keys, having_cond, top_projections
            )
        table, env, filters = self._collapse_below(agg.child)
        ds = self._ds(table)
        b = QueryBuilder(datasource=table)

        # ProjectFilterTransform
        for cond in filters:
            b = translate_filter(cond, ds, b)

        # AggregateTransform: grouping exprs
        dims = []
        dim_names = []
        for name, ge in agg.group_exprs:
            spec, b = translate_group_expr(
                name, substitute(ge, env), ds, b, lookups=self.catalog.lookup
            )
            dims.append(spec)
            dim_names.append(spec.name)
        b = b.with_(dimensions=tuple(dims))

        # AggregateTransform: aggregate functions
        aggs: List = []
        posts: List = []
        for ae in agg.agg_exprs:
            ae2 = L.AggExpr(
                ae.name,
                ae.fn,
                substitute(ae.arg, env) if ae.arg is not None else None,
                ae.distinct,
                substitute(ae.filter, env) if ae.filter is not None else None,
                ae.args,
            )
            a_list, p_list, b = translate_aggregate(ae2, ds, b, self.cfg)
            aggs.extend(a_list)
            posts.extend(p_list)
        # identical hidden aggregations collapse (frozen dataclasses hash):
        # N APPROX_QUANTILE fractions over one column emit N copies of the
        # same content-named sketch — compute it once
        aggs = list(dict.fromkeys(aggs))
        b = b.with_(
            aggregations=tuple(aggs), post_aggregations=tuple(posts)
        )

        # post-aggregate projections (SELECT exprs over agg outputs)
        host_posts: List[Tuple[str, E.Expr]] = []
        output_columns: List[str] = []
        post_names = {p.name for p in posts}
        agg_names = [a.name for a in aggs]
        if top_projections is not None:
            out_exprs = top_projections
        elif agg.post_exprs:
            out_exprs = agg.post_exprs
        else:
            out_exprs = None
        if out_exprs is not None:
            new_posts = list(b.post_aggregations)
            for name, pe in out_exprs:
                if isinstance(pe, E.Col) and pe.name in dim_names:
                    output_columns.append(pe.name)
                    continue
                if isinstance(pe, E.AggRef) and (
                    pe.name in agg_names or pe.name in post_names
                ):
                    output_columns.append(pe.name)
                    continue
                p = translate_post_expr(name, pe)
                if p is not None:
                    new_posts.append(p)
                else:
                    host_posts.append((name, pe))
                output_columns.append(name)
            b = b.with_(post_aggregations=tuple(new_posts))
        else:
            output_columns = dim_names + [
                n for n in agg_names if not _is_avg_helper(n, post_names)
            ] + list(post_names)

        # HAVING
        residual_having = None
        if having_cond is not None:
            spec, residual_having = translate_having(having_cond)
            if spec is not None:
                b = b.with_(having=spec)

        # grouping sets (CUBE/ROLLUP)
        if agg.grouping_sets:
            b = b.with_(grouping_sets=tuple(agg.grouping_sets))

        # LimitTransform.  A sort key naming a HOST-residual projection
        # (e.g. a GROUPING() bit expression) cannot be ordered on the
        # device — the column only exists after host finalize; route the
        # whole query to the fallback rather than KeyError mid-execution.
        host_post_names = {n for n, _ in host_posts}
        for k in sort_keys:
            if (
                isinstance(k.expr, (E.Col, E.AggRef))
                and k.expr.name in host_post_names
            ):
                raise RewriteError(
                    f"ORDER BY {k.expr.name} references a host-residual "
                    "projection; host fallback required"
                )
        rankable = agg_names + list(post_names)
        b = apply_sort_limit(b, sort_keys, limit, offset, self.cfg, rankable)
        b = b.with_(output_columns=tuple(output_columns))

        # guards (maxResultCardinality analog).  Declared functional
        # dependencies tighten the estimate: grouping by a dependent column
        # alongside its determinant cannot multiply the group count
        # (c_city -> c_nation: |city x nation| is really <= |city|).
        star = self.catalog.star_schema(table)

        # FD grouping pruning (the reference's FunctionalDependency put to
        # work): a grouped column determined by another grouped column is
        # dropped from the kernel grouping — every row of a group shares
        # one value for it, so a hidden max-over-codes aggregation carries
        # it and the API decodes it back.  TPC-H q10's GROUP BY
        # c_custkey, c_name, c_acctbal, ... would otherwise build a group
        # domain that is the PRODUCT of those cardinalities.
        fd_restores: List[Tuple[str, str, str]] = []
        if star is not None and not agg.grouping_sets and len(dims) > 1:
            limit_cols = {
                c.dimension for c in (b.limit_spec.columns if b.limit_spec else ())
            }
            deps_by_col = {}
            for fd in star.functional_dependencies:
                if fd.dependent != fd.determinant:
                    deps_by_col.setdefault(fd.dependent, set()).add(
                        fd.determinant
                    )
            kept = []
            pruned = []
            plain = {
                d.dimension
                for d in dims
                if (d.extraction is None and d.granularity is None
                    and d.dimension in ds.dicts)
            }
            pruned_names: set = set()
            for d in dims:
                # greedy in declaration order; the pruned-so-far check
                # keeps one member of any FD cycle (a->b, b->a) and
                # guarantees every pruned column's determinant chain
                # bottoms out in a KEPT dimension
                prunable = (
                    d.extraction is None
                    and d.granularity is None
                    and d.dimension in ds.dicts
                    # the code-max carrier rides f32: codes >= 2^24 would
                    # round and decode to an ADJACENT dictionary entry
                    and ds.dicts[d.dimension].cardinality < (1 << 24)
                    and d.name not in limit_cols
                    and any(
                        det in plain
                        and det != d.dimension
                        and det not in pruned_names
                        for det in deps_by_col.get(d.dimension, ())
                    )
                )
                if prunable:
                    pruned.append(d)
                    pruned_names.add(d.dimension)
                else:
                    kept.append(d)
            if pruned:
                from ..models import aggregations as A

                for d in pruned:
                    hidden = f"__fd_{d.name}"
                    aggs.append(A.DimCodeMax(hidden, d.dimension))
                    fd_restores.append((d.name, hidden, d.dimension))
                dims = kept
                b = b.with_(
                    dimensions=tuple(dims), aggregations=tuple(aggs)
                )
                log.debug(
                    "FD pruning: %s carried by hidden code aggs; kernel "
                    "dims now %s",
                    [r[0] for r in fd_restores],
                    [d.name for d in dims],
                )
        fd_dependents = set()
        if star is not None:
            grouped = {d.dimension for d in dims}
            for fd in star.functional_dependencies:
                if (
                    fd.determinant in grouped
                    and fd.dependent in grouped
                    and fd.dependent != fd.determinant
                ):
                    fd_dependents.add(fd.dependent)
        G_result = 1  # distinct output rows (FD-aware): the result guard
        G_kernel = 1  # kernel group-id domain (row-major product): explain
        for d in dims:
            card = _estimate_dim_cardinality(d, ds)
            G_kernel *= card
            if d.dimension not in fd_dependents:
                G_result *= card
        if G_result > self.cfg.max_result_cardinality:
            raise RewritePolicyError(
                f"estimated result cardinality {G_result} exceeds "
                f"max_result_cardinality={self.cfg.max_result_cardinality}"
            )

        q = b.build()
        phys = choose_physical(q, ds, G_kernel, self.cfg, self.n_devices, device=self.device)
        log.debug("rewrite: %s over %s -> strategy=%s groups=%d", type(q).__name__, table,
                  phys.strategy, G_kernel)
        return Rewrite(
            datasource=table,
            builder=b,
            query=q,
            physical=phys,
            num_groups=G_kernel,
            output_columns=tuple(output_columns),
            dim_names=tuple(dim_names),
            residual_having=residual_having,
            host_post_exprs=tuple(host_posts),
            grouping_sets=tuple(agg.grouping_sets),
            fd_restores=tuple(fd_restores),
        )

    # -- exact COUNT(DISTINCT): two-phase plan -------------------------------

    def _plan_exact_distinct(
        self,
        agg: L.Aggregate,
        limit: Optional[int],
        offset: int,
        sort_keys: List[L.SortKey],
        having_cond: Optional[E.Expr],
        top_projections,
    ) -> Rewrite:
        """COUNT(DISTINCT x) becomes x added to an inner grouping, finished
        on the host.  Every other aggregate must re-aggregate exactly
        (sum/count -> sum, min/max -> min/max, avg -> its sum and count
        parts); approximate sketches cannot, and are rejected."""
        if agg.grouping_sets:
            raise RewriteError(
                "exact COUNT(DISTINCT) with CUBE/ROLLUP unsupported "
                "(set count_distinct_mode='approx')"
            )
        distinct_outs: List[Tuple[str, str]] = []
        inner_aggs: List[L.AggExpr] = []
        outer_ops: List[Tuple[str, str]] = []
        count_like: List[str] = []
        avg_div: List[Tuple[str, str, str]] = []
        extra_dims: Dict[str, E.Expr] = {}
        for ae in agg.agg_exprs:
            if ae.distinct and ae.fn in ("sum", "avg"):
                raise RewriteError(
                    f"{ae.fn.upper()}(DISTINCT) cannot re-aggregate exactly"
                )
            if _is_count_distinct(ae):
                if not isinstance(ae.arg, E.Col):
                    raise RewriteError(
                        "exact COUNT(DISTINCT) over expressions unsupported"
                    )
                if ae.filter is not None:
                    raise RewriteError("exact COUNT(DISTINCT) with FILTER unsupported")
                extra_dims.setdefault(ae.arg.name, ae.arg)
                distinct_outs.append((ae.name, ae.arg.name))
            elif ae.fn == "approx_count_distinct":
                raise RewriteError(
                    "cannot mix exact COUNT(DISTINCT) with approx sketches "
                    "in one query (sketch states do not re-aggregate "
                    "exactly); use count_distinct_mode='approx'"
                )
            elif ae.fn == "avg":
                # not the "__sum"/"__cnt" suffixes: the inner plan's default
                # projection drops those as AVG-rewrite helpers
                sname, cname = f"__ed_{ae.name}_sum", f"__ed_{ae.name}_cnt"
                inner_aggs.append(L.AggExpr(sname, "sum", ae.arg, False, ae.filter))
                inner_aggs.append(L.AggExpr(cname, "count", None, False, ae.filter))
                outer_ops += [(sname, "sum"), (cname, "sum")]
                count_like.append(cname)
                avg_div.append((ae.name, sname, cname))
            elif ae.fn in ("sum", "count"):
                inner_aggs.append(ae)
                outer_ops.append((ae.name, "sum"))
                if ae.fn == "count":
                    count_like.append(ae.name)
            elif ae.fn in ("min", "max"):
                inner_aggs.append(ae)
                outer_ops.append((ae.name, ae.fn))
            else:
                raise RewriteError(
                    f"aggregate {ae.fn!r} cannot re-aggregate exactly "
                    "alongside exact COUNT(DISTINCT)"
                )

        inner = L.Aggregate(
            agg.group_exprs + tuple((f"__dist_{n}", e) for n, e in extra_dims.items()),
            tuple(inner_aggs),
            agg.child,
        )
        try:
            inner_rw = self._plan_aggregate(inner, None, 0, [], None, None)
        except RewritePolicyError:
            raise  # a policy rejection keeps its type
        except RewriteError as e:
            raise RewriteError(
                "exact COUNT(DISTINCT) plans its argument as an inner "
                f"grouping dimension, which failed: {e} (metric-typed "
                "arguments need count_distinct_mode='approx')"
            ) from e
        distinct_outs = [(name, f"__dist_{col}") for name, col in distinct_outs]

        dim_names = tuple(n for n, _ in agg.group_exprs)
        known = (
            set(dim_names)
            | {n for n, _ in outer_ops}
            | {n for n, _ in distinct_outs}
            | {n for n, _, _ in avg_div}
        )
        post_exprs: List[Tuple[str, E.Expr]] = []
        output_columns: List[str] = []
        out_exprs = top_projections if top_projections is not None else agg.post_exprs
        if out_exprs:
            for name, pe in out_exprs:
                if isinstance(pe, (E.Col, E.AggRef)) and pe.name in known:
                    output_columns.append(pe.name)
                    continue
                post_exprs.append((name, pe))
                output_columns.append(name)
        else:
            # declaration order, as the approx path's default: the column
            # order must not depend on count_distinct_mode
            output_columns = list(dim_names) + [ae.name for ae in agg.agg_exprs]

        skeys: List[Tuple[str, bool]] = []
        for sk in sort_keys:
            if not isinstance(sk.expr, (E.Col, E.AggRef)):
                raise RewriteError(
                    "exact COUNT(DISTINCT) supports ORDER BY on named columns only"
                )
            skeys.append((sk.expr.name, sk.ascending))

        return dataclasses.replace(
            inner_rw,
            exact_distinct=ExactDistinctOuter(
                inner=inner_rw,
                dim_names=dim_names,
                distinct_outs=tuple(distinct_outs),
                outer_ops=tuple(outer_ops),
                count_like=tuple(count_like),
                avg_div=tuple(avg_div),
                post_exprs=tuple(post_exprs),
                having=having_cond,
                sort_keys=tuple(skeys),
                limit=limit,
                offset=offset,
                output_columns=tuple(output_columns),
            ),
        )

    # -- scan path -----------------------------------------------------------

    def _plan_scan(
        self, node, limit, offset, sort_keys, top_projections
    ) -> Rewrite:
        """A non-aggregate plan -> a ScanQuery: projections that are not
        bare columns become virtual columns, and ORDER BY, LIMIT and OFFSET
        carry over.  What the scan cannot honour raises RewriteError (the
        host fallback answers it: windows, set operations, joins,
        untranslatable filters, an ORDER BY over an expression)."""
        env: Dict[str, E.Expr] = {}
        filters: List[E.Expr] = []
        proj = top_projections
        while not isinstance(node, L.Scan):
            if isinstance(node, L.Filter):
                filters.append(substitute(node.condition, env))
                node = node.child
            elif isinstance(node, L.Project):
                if proj is None:
                    proj = node.exprs
                for name, e in node.exprs:
                    env[name] = substitute(e, env)
                node = node.child
            else:
                raise RewriteError(f"cannot rewrite scan node {type(node).__name__}")
        ds = self._ds(node.table)
        b = QueryBuilder(datasource=node.table)
        for cond in filters:
            b = translate_filter(cond, ds, b)
        columns: List[str] = []
        vcols: List[Q.VirtualColumn] = []
        if proj:
            for name, e in proj:
                e = substitute(e, env)
                if isinstance(e, E.Col):
                    columns.append(e.name)
                else:
                    vcols.append(Q.VirtualColumn(name, e))
                    columns.append(name)
        else:
            columns = [c.name for c in ds.columns]
        # ORDER BY on a row scan must be honored or rejected: unsorted rows
        # under LIMIT are wrong rows
        order_by = []
        known = set(columns) | {c.name for c in ds.columns}
        for sk in sort_keys or ():
            # a SELECT alias of a computed projection is sortable as-is (the
            # engine evaluates virtual columns before sorting): check the
            # raw name before substitution expands the alias
            if isinstance(sk.expr, E.Col) and sk.expr.name in set(columns):
                name = sk.expr.name
            else:
                e = substitute(sk.expr, env)
                if not isinstance(e, E.Col) or e.name not in known:
                    raise RewriteError(
                        f"cannot ORDER BY {sk.expr} on a non-aggregate "
                        "scan (only projected or physical columns)"
                    )
                name = e.name
            order_by.append(Q.OrderByColumnSpec(
                name, "ascending" if sk.ascending else "descending"))
        q = Q.ScanQuery(
            datasource=node.table,
            columns=tuple(columns),
            filter=b.filter,
            intervals=b.intervals,
            limit=limit,
            virtual_columns=tuple(vcols),
            order_by=tuple(order_by),
            offset=offset or 0,
        )
        return Rewrite(
            datasource=node.table,
            builder=b,
            query=q,
            physical=choose_physical(q, self._ds(node.table), 1, self.cfg, self.n_devices,
                                     device=self.device),
            num_groups=0,
            output_columns=tuple(columns),
            dim_names=(),
            residual_having=None,
            host_post_exprs=(),
            grouping_sets=(),
            is_scan=True,
        )

    # -- explain (EXPLAIN DRUID REWRITE analog) ------------------------------

    def explain(self, lp: L.LogicalPlan, engine, strategy: Optional[str] = None) -> str:
        """The logical plan, the rewritten query spec, the cost model's
        decision (`PhysicalPlan.describe`), and the paths `engine` tries for
        it under `strategy` (`Engine.tiers`; None: the plan's class): the
        first is printed as the strategy, the rest are where it goes on a
        decline."""
        lines = ["== Logical Plan ==", lp.pretty(), ""]
        try:
            rw = self.plan(lp)
            if strategy is None:
                strategy = rw.physical.strategy
            tiers = (["scan"] if rw.is_scan
                     else engine.tiers(rw.query, self._ds(rw.datasource), strategy))
            lines += [
                "== Rewrite: %s ==" % type(rw.query).__name__,
                rw.to_json(),
                "",
                "== Physical Plan ==",
                rw.physical.describe(),
                f"strategy={tiers[0]} tiers={'>'.join(tiers)} "
                f"estimated_groups={rw.num_groups} device={engine.device}",
            ]
            if rw.exact_distinct is not None:
                lines.append(
                    "exact COUNT(DISTINCT) (host): re-aggregates the inner "
                    "grouping by " + ", ".join(rw.exact_distinct.dim_names or ("()",))
                )
            if rw.residual_having is not None:
                lines.append(f"residual HAVING (host): {rw.residual_having}")
            if rw.host_post_exprs:
                lines.append(
                    "residual projections (host): "
                    + ", ".join(n for n, _ in rw.host_post_exprs)
                )
        except RewriteError as e:
            lines += ["== Rewrite FAILED ==", str(e)]
        return "\n".join(lines)

    def _ds(self, table: str) -> DataSource:
        ds = self.catalog.get(table)
        if ds is None:
            raise RewriteError(f"unknown table {table!r}")
        return ds


def _estimate_dim_cardinality(d, ds: DataSource) -> int:
    """Plan-time group-count estimate per dimension (drives the result-
    cardinality guard and `explain`; the engine computes exact counts
    at lowering)."""
    from ..models.dimensions import TimeFieldExtraction

    if isinstance(d.extraction, TimeFieldExtraction):
        field = d.extraction.field
        if field == "year":
            iv = ds.interval()
            if iv is not None:
                return max(1, int((iv[1] - iv[0]) // 31_536_000_000) + 2)
            return 300
        return {"month": 12, "day": 31, "hour": 24, "minute": 60,
                "second": 60}[field]
    if d.dimension in ds.dicts:
        return ds.cardinality(d.dimension) + 1
    if d.dimension == "__time" and d.granularity is not None:
        iv = ds.interval()
        from ..utils.granularity import granularity_period_ms

        try:
            p = granularity_period_ms(d.granularity)
        except ValueError:
            p = None
        if iv is not None and p:
            return max(1, int((iv[1] - iv[0]) // p) + 2)
    return 4096


def _plan_contains_subquery(lp: L.LogicalPlan) -> bool:
    """Any IN/scalar subquery in any expression position of the plan tree."""
    from .transforms import _contains_subquery

    def exprs_of(node):
        if isinstance(node, (L.Filter, L.Having)):
            yield node.condition
        elif isinstance(node, L.Project):
            for _, e in node.exprs:
                yield e
        elif isinstance(node, L.Aggregate):
            for _, e in node.group_exprs:
                yield e
            for ae in node.agg_exprs:
                if ae.arg is not None:
                    yield ae.arg
                if ae.filter is not None:
                    yield ae.filter
            for _, e in node.post_exprs:
                yield e
        elif isinstance(node, L.Sort):
            for k in node.keys:
                yield k.expr

    if any(_contains_subquery(e) for e in exprs_of(lp)):
        return True
    return any(_plan_contains_subquery(c) for c in lp.children())


def _contains_aggregate(n: L.LogicalPlan) -> bool:
    if isinstance(n, L.Aggregate):
        return True
    return any(_contains_aggregate(c) for c in n.children())


def _is_avg_helper(name: str, post_names) -> bool:
    return name.endswith("__sum") or name.endswith("__cnt")


def _is_count_distinct(ae: L.AggExpr) -> bool:
    """Both liftings of COUNT(DISTINCT x): the SQL parser produces
    fn="count_distinct"; the builder API produces fn="count" + distinct."""
    return ae.fn == "count_distinct" or (ae.fn == "count" and ae.distinct)
