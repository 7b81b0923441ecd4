"""Logical plan — the planner's input language.

Reference parity: the reference pattern-matches *Catalyst* logical plans
(Aggregate / Project / Filter / Sort / Limit / Join over a relation) inside
`DruidPlanner`'s transforms (SURVEY.md §2 DruidPlanner/AggregateTransform rows
`[U]`).  We are standalone, so we define our own small logical algebra with
the same node set; the SQL frontend (sql/) and the DataFrame-style builder
(api.py) both lower to it.  Expressions inside nodes are `plan.expr.Expr`
trees (the Catalyst-expression analog).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from .expr import Expr


class LogicalPlan:
    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = pad + self._label()
        return "\n".join([head] + [c.pretty(indent + 1) for c in self.children()])

    def _label(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Scan(LogicalPlan):
    """Scan of a registered datasource (the `DruidRelation` leaf analog)."""

    table: str

    def _label(self):
        return f"Scan({self.table})"


@dataclasses.dataclass(frozen=True)
class Filter(LogicalPlan):
    condition: Expr
    child: LogicalPlan

    def children(self):
        return (self.child,)

    def _label(self):
        return f"Filter({self.condition})"


@dataclasses.dataclass(frozen=True)
class Project(LogicalPlan):
    exprs: Tuple[Tuple[str, Expr], ...]  # (output name, expression)
    child: LogicalPlan

    def children(self):
        return (self.child,)

    def _label(self):
        return "Project(" + ", ".join(n for n, _ in self.exprs) + ")"


@dataclasses.dataclass(frozen=True)
class AggExpr:
    """One aggregate output: fn over an expression, optional DISTINCT and
    FILTER (the Catalyst AggregateExpression analog)."""

    name: str
    fn: str  # sum | count | min | max | avg | count_distinct |
    #          approx_count_distinct | hll | theta | approx_quantile
    arg: Optional[Expr]  # None for count(*)
    distinct: bool = False
    filter: Optional[Expr] = None
    args: tuple = ()  # extra literal args (approx_quantile: fraction[, k])

    def __str__(self):
        inner = "*" if self.arg is None else str(self.arg)
        extra = "".join(f", {a}" for a in self.args)
        d = "DISTINCT " if self.distinct else ""
        f = f" FILTER ({self.filter})" if self.filter is not None else ""
        return f"{self.fn}({d}{inner}{extra}){f}"


@dataclasses.dataclass(frozen=True)
class Aggregate(LogicalPlan):
    group_exprs: Tuple[Tuple[str, Expr], ...]
    agg_exprs: Tuple[AggExpr, ...]
    child: LogicalPlan
    # post-aggregate projections: expressions over agg output names (AggRef)
    post_exprs: Tuple[Tuple[str, Expr], ...] = ()
    # grouping sets: tuples of indices into group_exprs; () = plain GROUP BY
    grouping_sets: Tuple[Tuple[int, ...], ...] = ()

    def children(self):
        return (self.child,)

    def _label(self):
        g = ", ".join(n for n, _ in self.group_exprs)
        a = ", ".join(str(a) for a in self.agg_exprs)
        gs = f" sets={self.grouping_sets}" if self.grouping_sets else ""
        return f"Aggregate(by=[{g}], aggs=[{a}]{gs})"


@dataclasses.dataclass(frozen=True)
class Having(LogicalPlan):
    condition: Expr  # over AggRef / group columns
    child: LogicalPlan

    def children(self):
        return (self.child,)

    def _label(self):
        return f"Having({self.condition})"


@dataclasses.dataclass(frozen=True)
class SortKey:
    expr: Expr
    ascending: bool = True


@dataclasses.dataclass(frozen=True)
class Sort(LogicalPlan):
    keys: Tuple[SortKey, ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    def _label(self):
        return "Sort(" + ", ".join(
            f"{k.expr} {'asc' if k.ascending else 'desc'}" for k in self.keys
        ) + ")"


@dataclasses.dataclass(frozen=True)
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan
    offset: int = 0

    def children(self):
        return (self.child,)

    def _label(self):
        return f"Limit({self.n}" + (f", offset={self.offset})" if self.offset else ")")


@dataclasses.dataclass(frozen=True)
class Union(LogicalPlan):
    """SQL set operation: branches aligned by position, column names from
    the first branch.  Not pushable (the reference fell back to Spark for
    every set operation); the host fallback implements the semantics.

    `op` is one of:
      union_all      bag concatenation
      union          set union (distinct rows; NULLs compare equal)
      intersect      set intersection (distinct)
      intersect_all  bag intersection (per-row multiplicity = min of counts)
      except         set difference (distinct left rows absent from right)
      except_all     bag difference (multiplicity = left count - right count)

    union_all / union / intersect / intersect_all are associative and may
    be n-ary; except / except_all are built strictly binary (left fold)."""

    branches: Tuple[LogicalPlan, ...]
    op: str = "union_all"

    def children(self):
        return self.branches

    def _label(self):
        return f"Union({self.op}, {len(self.branches)} branches)"


@dataclasses.dataclass(frozen=True)
class WindowExpr:
    """One window-function column.  `frame` is a pair of row offsets
    relative to the current row, inclusive: -N = N PRECEDING, 0 = CURRENT
    ROW, +N = N FOLLOWING, None = UNBOUNDED on that side.  A frame of
    None (no explicit frame) means the SQL default: with ORDER BY, RANGE
    UNBOUNDED PRECEDING..CURRENT ROW (peer rows included); without,
    the whole partition."""

    name: str
    fn: str
    arg: Optional["Expr"]  # None for row_number/rank/dense_rank/count(*)
    args: tuple = ()  # literal extras: NTILE n, LAG/LEAD offset + default
    filter: Optional["Expr"] = None  # FILTER (WHERE ...) on window aggs
    partition: Tuple["Expr", ...] = ()
    order_exprs: Tuple["Expr", ...] = ()
    order_asc: Tuple[bool, ...] = ()
    frame: Optional[Tuple[Optional[int], Optional[int]]] = None


@dataclasses.dataclass(frozen=True)
class Window(LogicalPlan):
    """Window-function evaluation over the child's frame (the reference
    fell back to Spark for every OVER clause; here the host fallback
    implements the semantics).  `wins` computes one hidden column per
    window call; `out_exprs` is the full SELECT-order output list — a
    plain Col(name) passes a child column through, anything else is
    evaluated over the frame (with window columns visible)."""

    wins: Tuple[WindowExpr, ...]
    out_exprs: Tuple[Tuple[str, "Expr"], ...]
    child: LogicalPlan

    def children(self):
        return (self.child,)

    def _label(self):
        fns = ", ".join(f"{w.fn}->{w.name}" for w in self.wins)
        return f"Window([{fns}])"


@dataclasses.dataclass(frozen=True)
class SubqueryScan(LogicalPlan):
    """A derived table's scope boundary: the outer query may reference ONLY
    `columns` (the subquery's SELECT list; None when it is SELECT *).  The
    planner never rewrites through it — without the boundary the planner's
    Project-collapsing walk would silently resolve renamed-away names
    against the base table."""

    child: LogicalPlan
    columns: Optional[Tuple[str, ...]]
    alias: str = ""

    def children(self):
        return (self.child,)

    def _label(self):
        cols = "*" if self.columns is None else ", ".join(self.columns)
        return f"SubqueryScan({self.alias}: [{cols}])"


@dataclasses.dataclass(frozen=True)
class Join(LogicalPlan):
    """Equi-join; the star-schema collapse (JoinTransform analog) eliminates
    these when they conform to the declared star schema."""

    left: LogicalPlan
    right: LogicalPlan
    left_keys: Tuple[str, ...]
    right_keys: Tuple[str, ...]
    how: str = "inner"

    def children(self):
        return (self.left, self.right)

    def _label(self):
        return (
            f"Join({self.how}, "
            + " AND ".join(
                f"{l}={r}" for l, r in zip(self.left_keys, self.right_keys)
            )
            + ")"
        )
