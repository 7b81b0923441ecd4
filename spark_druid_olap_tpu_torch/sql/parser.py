"""SQL parser + analyzer: SQL text -> logical plan.

Recursive descent over the lexer's tokens.  The grammar covers the OLAP
subset the reference accelerates (SURVEY.md §2/§4 `[U]`: aggregate SELECTs
with filters, time predicates, GROUP BY (+CUBE/ROLLUP/GROUPING SETS), HAVING,
ORDER BY/LIMIT, star joins) plus `EXPLAIN REWRITE <sql>` — the analog of the
reference's `EXPLAIN DRUID REWRITE` parser extension.

The analyzer (bottom of file) splits SELECT items into grouping outputs,
aggregate calls, and post-aggregate expressions (AggRef substitution), then
assembles the logical plan tree the planner consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..plan import expr as E
from ..plan import logical as L
from .lexer import Token, tokenize

AGG_FNS = {"sum", "count", "avg", "min", "max", "approx_count_distinct"}

#: functions that only exist with an OVER clause (ranking / offset family);
#: aggregate functions become window calls when OVER follows them
WINDOW_FNS = {
    "row_number", "rank", "dense_rank", "ntile",
    "lag", "lead", "first_value", "last_value",
    "percent_rank", "cume_dist", "nth_value",
}
#: aggregates legal inside OVER (sketches/quantiles are not)
WINDOW_AGG_FNS = {"sum", "count", "avg", "min", "max"}


class ParseError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class AggCall(E.Expr):
    """Parser-level aggregate call; the analyzer lifts these out of SELECT
    expressions into Aggregate.agg_exprs and replaces them with AggRefs."""

    fn: str
    arg: Optional[E.Expr]
    distinct: bool = False
    filter: Optional[E.Expr] = None
    args: tuple = ()  # extra literal args (APPROX_QUANTILE's fraction, k)

    def __str__(self):
        # feeds the analyzer's dedup key: every distinguishing field must
        # appear, or two different aggregates collapse into one AggRef
        inner = "*" if self.arg is None else str(self.arg)
        extra = "".join(f", {a}" for a in self.args)
        return f"{self.fn}({'DISTINCT ' if self.distinct else ''}{inner}{extra})"


@dataclasses.dataclass(frozen=True)
class GroupingCall(E.Expr):
    """SQL GROUPING(col): 1 when `col` is rolled away in the current
    grouping set, else 0.  The analyzer desugars it to a bit test over the
    __grouping_id column the grouping-set machinery already emits."""

    col: E.Expr

    def __str__(self):
        return f"grouping({self.col})"


@dataclasses.dataclass(frozen=True)
class WindowCall(E.Expr):
    """Parser-level `fn(...) OVER (...)`; the analyzer lifts these into
    `L.Window` specs and replaces them with hidden-column Col refs.  Field
    layout mirrors `L.WindowExpr` (flat Expr tuples, so the generic
    dataclass walkers — _strip_qualifiers, _contains_agg, columns() —
    traverse the spec without special cases)."""

    fn: str
    arg: Optional[E.Expr]
    args: tuple = ()  # literal extras: NTILE n, LAG/LEAD offset + default
    filter: Optional[E.Expr] = None
    partition: Tuple[E.Expr, ...] = ()
    order_exprs: Tuple[E.Expr, ...] = ()
    order_asc: Tuple[bool, ...] = ()
    frame: Optional[tuple] = None

    def __str__(self):
        inner = "*" if self.arg is None else str(self.arg)
        extra = "".join(f", {a}" for a in self.args)
        pb = " PARTITION BY " + ", ".join(map(str, self.partition)) if self.partition else ""
        ob = (
            " ORDER BY "
            + ", ".join(
                f"{e}{'' if a else ' DESC'}"
                for e, a in zip(self.order_exprs, self.order_asc)
            )
            if self.order_exprs
            else ""
        )
        fr = f" ROWS {self.frame}" if self.frame is not None else ""
        return f"{self.fn}({inner}{extra}) OVER ({pb}{ob}{fr})".strip()


@dataclasses.dataclass
class SelectStmt:
    items: List[Tuple[Optional[str], E.Expr]]  # (alias, expr)
    table: Any  # str | JoinClause | Subquery
    where: Optional[E.Expr]
    group_by: List[E.Expr]
    group_mode: str  # "plain" | "cube" | "rollup" | "sets"
    grouping_sets: List[List[E.Expr]]
    having: Optional[E.Expr]
    order_by: List[Tuple[E.Expr, bool]]
    limit: Optional[int]
    offset: int
    explain: bool = False
    distinct: bool = False


@dataclasses.dataclass
class UnionStmt:
    """Set-operation chain (UNION [ALL] / INTERSECT [ALL] / EXCEPT [ALL]);
    `ops[i]` connects branches[i] and branches[i+1].  Kept flat at parse
    time; `parse_sql` folds it into a logical tree with SQL precedence
    (INTERSECT binds tighter than UNION/EXCEPT, both left-associative).
    Trailing ORDER BY / LIMIT from the last branch apply to the combined
    result (column names come from the first branch)."""

    branches: List[SelectStmt]
    ops: List[str]
    order_by: List[Tuple[E.Expr, bool]]
    limit: Optional[int]
    offset: int
    explain: bool = False


@dataclasses.dataclass
class Subquery:
    """A derived table: FROM (SELECT ...) alias.  The planner cannot push
    nested queries down (the reference fell back to Spark for them too), so
    these execute on the host fallback interpreter — but they parse and
    plan like any other relation."""

    stmt: "SelectStmt"
    alias: str
    aliases: tuple = ()  # inner-visible alias->table items (parse time)


@dataclasses.dataclass
class JoinClause:
    left: Any  # str | JoinClause (Subquery is rejected in join position)
    right: str
    right_alias: Optional[str]
    on: List[Tuple[str, str]]  # (left col, right col) qualified names
    how: str


class Parser:
    def __init__(self, sql: str, views: Optional[Dict[str, str]] = None):
        self.toks = tokenize(sql)
        self.i = 0
        self.views = views or {}  # view name -> defining SELECT text
        self.aliases: Dict[str, str] = {}  # alias -> table
        # alias names registered by the CURRENT select's FROM clause —
        # needed for correlation scoping: an alias that exists in both the
        # inner and an outer scope resolves INNER (SQL: innermost wins),
        # which a dict-diff against the outer scope cannot see when the
        # two registrations are identical (review-confirmed wrong-answer)
        self._scopes: List[set] = []
        self._last_scope: set = set()

    # -- token helpers -------------------------------------------------------

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "KW" and t.value.lower() in kws:
            self.next()
            return t.value.lower()
        return None

    def expect_kw(self, kw: str):
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()} at {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "OP" and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r} at {self.peek().value!r}")

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind == "IDENT":
            self.next()
            return t.value
        if t.kind == "KW":  # permissive: keywords as idents where unambiguous
            self.next()
            return t.value
        raise ParseError(f"expected identifier at {t.value!r}")

    # -- statement -----------------------------------------------------------

    def parse(self):
        explain = False
        if self.accept_kw("explain"):
            self.accept_kw("rewrite")  # EXPLAIN [REWRITE]
            explain = True
        stmt = self.select()
        stmt.explain = explain
        branches = [stmt]
        ops: List[str] = []
        while True:
            kw = self.accept_kw("union", "intersect", "except")
            if kw is None:
                break
            if kw == "union":
                # UNION DISTINCT == plain UNION
                mod = self.accept_kw("all", "distinct")
                ops.append("union_all" if mod == "all" else "union")
            else:
                ops.append(kw + ("_all" if self.accept_kw("all") else ""))
            branches.append(self.select())
        if self.accept_op(";"):
            pass
        if self.peek().kind != "EOF":
            raise ParseError(f"trailing input at {self.peek().value!r}")
        if len(branches) == 1:
            return stmt
        # the trailing ORDER BY / LIMIT the last branch parsed belong to
        # the whole set operation (SQL forbids them before UNION et al.)
        last = branches[-1]
        out = UnionStmt(
            branches=branches,
            ops=ops,
            order_by=last.order_by,
            limit=last.limit,
            offset=last.offset,
            explain=explain,
        )
        last.order_by, last.limit, last.offset = [], None, 0
        for b in branches[:-1]:
            # standard SQL forbids these before UNION; applying them
            # per-branch would silently change row counts
            if b.order_by or b.limit is not None or b.offset:
                raise ParseError(
                    "ORDER BY/LIMIT/OFFSET is only valid after the last "
                    "set-operation branch"
                )
        for b in branches:
            if len(b.items) != len(branches[0].items):
                raise ParseError(
                    "set-operation branches have different column counts"
                )
            if any(
                isinstance(e, E.Col) and e.name == "*" for _, e in b.items
            ):
                raise ParseError("SELECT * in a set operation unsupported")
        return out

    def select(self) -> SelectStmt:
        self._scopes.append(set())
        try:
            return self._select_body()
        finally:
            self._last_scope = self._scopes.pop()

    def _select_body(self) -> SelectStmt:
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        items: List[Tuple[Optional[str], E.Expr]] = []
        while True:
            if self.accept_op("*"):
                items.append((None, E.Col("*")))
            else:
                e = self.expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self.expect_ident()
                elif self.peek().kind == "IDENT":
                    alias = self.expect_ident()
                items.append((alias, e))
            if not self.accept_op(","):
                break
        self.expect_kw("from")
        table = self.table_ref()
        where = self.expr() if self.accept_kw("where") else None
        group_by: List[E.Expr] = []
        group_mode = "plain"
        grouping_sets: List[List[E.Expr]] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.accept_kw("cube"):
                group_mode = "cube"
                self.expect_op("(")
                group_by = self._expr_list()
                self.expect_op(")")
            elif self.accept_kw("rollup"):
                group_mode = "rollup"
                self.expect_op("(")
                group_by = self._expr_list()
                self.expect_op(")")
            elif self.accept_kw("grouping"):
                self.expect_kw("sets")
                group_mode = "sets"
                self.expect_op("(")
                while True:
                    self.expect_op("(")
                    s = self._expr_list() if not self.accept_op(")") else []
                    if s:
                        self.expect_op(")")
                    grouping_sets.append(s)
                    for e in s:
                        if not any(_expr_eq(e, g) for g in group_by):
                            group_by.append(e)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            else:
                group_by = self._expr_list()
        having = self.expr() if self.accept_kw("having") else None
        order_by: List[Tuple[E.Expr, bool]] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.expr()
                asc = True
                if self.accept_kw("desc"):
                    asc = False
                elif self.accept_kw("asc"):
                    asc = True
                order_by.append((e, asc))
                if not self.accept_op(","):
                    break
        limit = None
        offset = 0
        if self.accept_kw("limit"):
            limit = int(self.next().value)
        if self.accept_kw("offset"):
            offset = int(self.next().value)
        return self._bind_correlation(
            SelectStmt(
                items, table, where, group_by, group_mode, grouping_sets,
                having, order_by, limit, offset, distinct=distinct,
            )
        )

    def _bind_correlation(self, stmt: SelectStmt) -> SelectStmt:
        """Post-parse correlation marking.  SELECT items parse BEFORE the
        FROM clause registers aliases, so a subquery in the select list
        cannot know at its own parse time which qualifiers are outer —
        re-scan every expression-position subquery node now that this
        statement's full alias scope (self.aliases: this FROM plus any
        enclosing scopes mid-parse) is known."""
        import dataclasses as _dc

        visible = dict(self.aliases)

        def refs_of(node) -> tuple:
            inner_vis = dict(node.aliases or ())
            found = set(node.outer_refs or ())
            exprs = [e for _, e in node.stmt.items]
            exprs += node.stmt.group_by
            exprs += [e for e, _ in node.stmt.order_by]
            exprs += [
                x for x in (node.stmt.where, node.stmt.having)
                if x is not None
            ]
            for e in exprs:
                for c in e.columns():
                    if "." in c:
                        q = c.split(".", 1)[0]
                        if q not in inner_vis and q in visible:
                            found.add(c)
            return tuple(sorted(found))

        def _mark(e):
            if isinstance(
                e, (E.InSubquery, E.ExistsSubquery, E.ScalarSubquery)
            ):
                refs = refs_of(e)
                if refs != tuple(e.outer_refs or ()):
                    return _dc.replace(e, outer_refs=refs or None)
            return e

        def fix(e):
            return E.map_expr(e, _mark)

        return _dc.replace(
            stmt,
            items=[(n, fix(e)) for n, e in stmt.items],
            where=fix(stmt.where) if stmt.where is not None else None,
            having=fix(stmt.having) if stmt.having is not None else None,
            group_by=[fix(e) for e in stmt.group_by],
            order_by=[(fix(e), a) for e, a in stmt.order_by],
        )

    def _expr_list(self) -> List[E.Expr]:
        out = [self.expr()]
        while self.accept_op(","):
            out.append(self.expr())
        return out

    def _parse_subselect(self):
        """Parse a nested (SELECT ...) with alias isolation: the inner
        FROM's aliases must not leak into or clobber the outer scope.
        QUALIFIED references to OUTER tables inside the inner statement
        are correlation — collected and returned so the subquery node can
        carry them (the host fallback evaluates correlated subqueries per
        distinct outer binding); unqualified names still resolve inner
        only.  Returns (stmt, inner-visible alias items, outer_refs)."""
        saved = dict(self.aliases)
        inner = self.select()
        after = dict(self.aliases)
        self.aliases = saved
        # the inner statement's OWN aliases (from its FROM clause, via the
        # scope stack): a name registered by BOTH scopes resolves INNER —
        # a dict diff would miss identical registrations (same table, same
        # alias) and misread a self-reference as correlation
        inner_vis = {k: after[k] for k in self._last_scope if k in after}
        outer_refs = set()
        for _, e in list(inner.items) + [
            (None, x) for x in inner.group_by
        ] + [(None, x) for x, _ in inner.order_by] + [
            (None, x)
            for x in (inner.where, inner.having)
            if x is not None
        ]:
            for c in e.columns():
                if "." in c:
                    q = c.split(".", 1)[0]
                    if q not in inner_vis and q in saved:
                        outer_refs.add(c)
        return inner, tuple(sorted(inner_vis.items())), tuple(
            sorted(outer_refs)
        )

    def table_ref(self):
        if self.accept_op("("):
            # derived table: FROM (SELECT ...) [AS] alias — correlation is
            # not valid SQL here (that would be LATERAL)
            inner, inner_vis, outer_refs = self._parse_subselect()
            if outer_refs:
                raise ParseError(
                    "derived tables cannot reference outer aliases "
                    f"({', '.join(outer_refs)}): LATERAL is unsupported"
                )
            self.expect_op(")")
            has_as = self.accept_kw("as")
            if not has_as and self.peek().kind != "IDENT":
                # without this, a missing alias would swallow the next
                # clause keyword (WHERE/ORDER) as the alias
                raise ParseError("derived table requires an alias")
            alias = self.expect_ident()
            self.aliases[alias] = alias
            if self._scopes:
                self._scopes[-1].add(alias)
            if self.peek().kind == "KW" and self.peek().value.lower() in (
                "join", "inner", "left"
            ):
                raise ParseError("JOIN over a derived table unsupported")
            return Subquery(inner, alias, inner_vis)
        name = self.expect_ident()
        alias = None
        t = self.peek()
        if t.kind == "IDENT":
            alias = self.expect_ident()
        if name in self.views:
            # a view reference expands to a derived table of its defining
            # SELECT (re-parsed with the view itself removed, so chains
            # of views work and cycles cannot recurse)
            self.aliases[alias or name] = alias or name
            if self._scopes:
                self._scopes[-1].add(alias or name)
            if self.peek().kind == "KW" and self.peek().value.lower() in (
                "join", "inner", "left"
            ):
                raise ParseError("JOIN over a view unsupported")
            return self._view_subquery(name, alias)
        self.aliases[alias or name] = name
        if self._scopes:
            self._scopes[-1].add(alias or name)
        node: Any = name
        while True:
            how = None
            if self.accept_kw("inner"):
                self.expect_kw("join")
                how = "inner"
            elif self.accept_kw("left"):
                self.expect_kw("join")
                how = "left"
            elif self.accept_kw("join"):
                how = "inner"
            else:
                break
            rname = self.expect_ident()
            if rname in self.views:
                raise ParseError("a view cannot appear in join position")
            ralias = None
            if self.peek().kind == "IDENT":
                ralias = self.expect_ident()
            self.aliases[ralias or rname] = rname
            if self._scopes:
                self._scopes[-1].add(ralias or rname)
            self.expect_kw("on")
            on: List[Tuple[str, str]] = []
            while True:
                l = self._qualified_name()
                self.expect_op("=")
                r = self._qualified_name()
                on.append((l, r))
                if not self.accept_kw("and"):
                    break
            node = JoinClause(node, rname, ralias, on, how)
        return node

    def _view_subquery(self, name: str, alias: Optional[str]) -> Subquery:
        inner_views = {k: v for k, v in self.views.items() if k != name}
        p2 = Parser(self.views[name], views=inner_views)
        stmt = p2.parse()
        return Subquery(stmt, alias or name, tuple(p2.aliases.items()))

    def _qualified_name(self) -> str:
        a = self.expect_ident()
        if self.accept_op("."):
            b = self.expect_ident()
            return f"{a}.{b}"
        return a

    # -- expressions ---------------------------------------------------------

    def expr(self) -> E.Expr:
        return self._or()

    def _or(self) -> E.Expr:
        left = self._and()
        while self.accept_kw("or"):
            left = E.BoolOp("or", (left, self._and()))
        return left

    def _and(self) -> E.Expr:
        left = self._not()
        while self.accept_kw("and"):
            left = E.BoolOp("and", (left, self._not()))
        return left

    def _not(self) -> E.Expr:
        if self.accept_kw("not"):
            return E.BoolOp("not", (self._not(),))
        if self.accept_kw("exists"):
            # EXISTS (SELECT ...): the fallback resolves it to a constant
            # row-count check, or per outer binding when correlated
            self.expect_op("(")
            inner, inner_vis, outer_refs = self._parse_subselect()
            self.expect_op(")")
            return E.ExistsSubquery(
                inner, inner_vis, outer_refs=outer_refs or None
            )
        return self._cmp()

    def _cmp(self) -> E.Expr:
        left = self._add()
        t = self.peek()
        if t.kind == "OP" and t.value in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "==", "<>": "!="}.get(t.value, t.value)
            return E.Comparison(op, left, self._add())
        negated = False
        if self.peek().kind == "KW" and self.peek().value.lower() == "not":
            nxt = self.toks[self.i + 1]
            if nxt.kind == "KW" and nxt.value.lower() in ("in", "like", "between"):
                self.next()
                negated = True
        if self.accept_kw("between"):
            lo = self._add()
            self.expect_kw("and")
            hi = self._add()
            e: E.Expr = E.BoolOp(
                "and",
                (E.Comparison(">=", left, lo), E.Comparison("<=", left, hi)),
            )
            return E.BoolOp("not", (e,)) if negated else e
        if self.accept_kw("in"):
            self.expect_op("(")
            if (
                self.peek().kind == "KW"
                and self.peek().value.lower() == "select"
            ):
                inner, inner_vis, outer_refs = self._parse_subselect()
                self.expect_op(")")
                if len(inner.items) != 1:
                    raise ParseError(
                        "IN subquery must select exactly one column"
                    )
                e: E.Expr = E.InSubquery(
                    left, inner, inner_vis, outer_refs=outer_refs or None
                )
                return E.BoolOp("not", (e,)) if negated else e
            vals = []
            while True:
                v = self._primary()
                if not isinstance(v, E.Literal):
                    raise ParseError("IN list must be literals")
                vals.append(v.value)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            e = E.InExpr(left, tuple(vals))
            return E.BoolOp("not", (e,)) if negated else e
        if self.accept_kw("like"):
            t = self.next()
            if t.kind != "STRING":
                raise ParseError("LIKE requires a string pattern")
            return E.LikeExpr(left, t.value, negated=negated)
        if self.accept_kw("is"):
            neg = bool(self.accept_kw("not"))
            self.expect_kw("null")
            isnull = E.Comparison("==", left, E.Literal(None))
            return E.BoolOp("not", (isnull,)) if neg else isnull
        return left

    def _add(self) -> E.Expr:
        left = self._mul()
        while True:
            if self.accept_op("+"):
                left = E.BinaryOp("+", left, self._mul())
            elif self.accept_op("-"):
                left = E.BinaryOp("-", left, self._mul())
            else:
                return left

    def _mul(self) -> E.Expr:
        left = self._unary()
        while True:
            if self.accept_op("*"):
                left = E.BinaryOp("*", left, self._unary())
            elif self.accept_op("/"):
                left = E.BinaryOp("/", left, self._unary())
            elif self.accept_op("%"):
                left = E.BinaryOp("%", left, self._unary())
            else:
                return left

    def _unary(self) -> E.Expr:
        if self.accept_op("-"):
            return E.UnaryOp("-", self._unary())
        return self._primary()

    def _primary(self) -> E.Expr:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            v = float(t.value)
            if v.is_integer() and "." not in t.value and "e" not in t.value.lower():
                return E.Literal(int(t.value))
            return E.Literal(v)
        if t.kind == "STRING":
            self.next()
            return E.Literal(t.value)
        if t.kind == "KW":
            kw = t.value.lower()
            if kw in ("date", "timestamp"):
                self.next()
                s = self.next()
                if s.kind != "STRING":
                    raise ParseError(f"{kw.upper()} requires a string literal")
                ms = int(
                    np.datetime64(s.value).astype("datetime64[ms]").astype(np.int64)
                )
                return E.Literal(ms)
            if kw == "cast":
                self.next()
                self.expect_op("(")
                inner = self.expr()
                self.expect_kw("as")
                ty = self.expect_ident().lower()
                self.expect_op(")")
                to = {
                    "double": "double", "float": "double", "real": "double",
                    "bigint": "long", "int": "long", "integer": "long",
                    "long": "long", "boolean": "bool",
                }.get(ty)
                if to is None:
                    raise ParseError(f"CAST to {ty!r} unsupported")
                return E.Cast(inner, to)
            if kw == "extract":
                self.next()
                self.expect_op("(")
                field = self.expect_ident().lower()
                from ..plan.expr import _EXTRACT_FIELDS

                if field not in _EXTRACT_FIELDS:
                    raise ParseError(
                        f"EXTRACT field {field!r}; supported: "
                        f"{sorted(_EXTRACT_FIELDS)}"
                    )
                self.expect_kw("from")
                inner = self.expr()
                self.expect_op(")")
                return E.TimeExtract(field, inner)
            if kw == "case":
                return self._case()
            if kw in ("true", "false"):
                self.next()
                return E.Literal(kw == "true")
            if kw == "null":
                self.next()
                return E.Literal(None)
            if kw == "interval":
                raise ParseError("INTERVAL literals not supported; use ms")
        if t.kind == "IDENT" or t.kind == "KW":
            name = self.expect_ident()
            if self.accept_op("("):
                return self._maybe_over(self._call(name.lower()))
            if self.accept_op("."):
                col = self.expect_ident()
                return E.Col(f"{name}.{col}")
            return E.Col(name)
        if self.accept_op("("):
            if (
                self.peek().kind == "KW"
                and self.peek().value.lower() == "select"
            ):
                # scalar subquery: (SELECT max(v) FROM t ...) — resolved to
                # a literal (or a per-outer-binding column when correlated)
                # by the host fallback executor
                inner, inner_vis, outer_refs = self._parse_subselect()
                self.expect_op(")")
                if len(inner.items) != 1:
                    raise ParseError(
                        "scalar subquery must select exactly one column"
                    )
                return E.ScalarSubquery(
                    inner, inner_vis, outer_refs=outer_refs or None
                )
            e = self.expr()
            self.expect_op(")")
            return e
        raise ParseError(f"unexpected token {t.value!r}")

    def _case(self) -> E.Expr:
        self.expect_kw("case")
        # simple form: CASE operand WHEN value THEN ... (desugars to the
        # searched form with operand == value conditions)
        operand: Optional[E.Expr] = None
        t = self.peek()
        if not (t.kind == "KW" and t.value.lower() in ("when", "else", "end")):
            operand = self.expr()
        whens: List[Tuple[E.Expr, E.Expr]] = []
        otherwise: E.Expr = E.Literal(None)
        while self.accept_kw("when"):
            c = self.expr()
            if operand is not None:
                c = E.Comparison("==", operand, c)
            self.expect_kw("then")
            v = self.expr()
            whens.append((c, v))
        if self.accept_kw("else"):
            otherwise = self.expr()
        self.expect_kw("end")
        out = otherwise
        for c, v in reversed(whens):
            out = E.IfExpr(c, v, out)
        return out

    # -- window clauses ------------------------------------------------------

    def _accept_word(self, *words: str) -> Optional[str]:
        """Contextual (non-reserved) word: OVER/PARTITION/ROWS/... match as
        plain identifiers so they stay usable as column names elsewhere."""
        t = self.peek()
        if t.kind in ("IDENT", "KW") and t.value.lower() in words:
            self.next()
            return t.value.lower()
        return None

    def _expect_word(self, word: str):
        if not self._accept_word(word):
            raise ParseError(
                f"expected {word.upper()} at {self.peek().value!r}"
            )

    def _maybe_over(self, e: E.Expr) -> E.Expr:
        """Attach an OVER clause to the call that just parsed."""
        if not (
            self.peek().kind in ("IDENT", "KW")
            and self.peek().value.lower() == "over"
            and self.toks[self.i + 1].kind == "OP"
            and self.toks[self.i + 1].value == "("
        ):
            if isinstance(e, WindowCall):
                raise ParseError(f"{e.fn.upper()} requires an OVER clause")
            return e
        self.next()  # over
        self.expect_op("(")
        partition, order_exprs, order_asc, frame = self._over_clause()
        if isinstance(e, WindowCall):
            base = e
        elif isinstance(e, AggCall):
            if e.distinct:
                raise ParseError(
                    "DISTINCT aggregates in an OVER clause are unsupported"
                )
            if e.fn not in WINDOW_AGG_FNS:
                raise ParseError(
                    f"{e.fn.upper()} cannot be used as a window function"
                )
            base = WindowCall(e.fn, e.arg, e.args, filter=e.filter)
        else:
            raise ParseError("OVER must follow a function call")
        if base.fn in ("rank", "dense_rank", "ntile", "lag", "lead",
                       "percent_rank", "cume_dist"):
            if not order_exprs:
                raise ParseError(
                    f"{base.fn.upper()} requires ORDER BY in its OVER clause"
                )
            if frame is not None:
                raise ParseError(
                    f"{base.fn.upper()} does not accept a frame clause"
                )
        return dataclasses.replace(
            base,
            partition=tuple(partition),
            order_exprs=tuple(order_exprs),
            order_asc=tuple(order_asc),
            frame=frame,
        )

    def _over_clause(self):
        """Parses the body of OVER ( ... ) up to and including the `)`."""
        partition: List[E.Expr] = []
        if self._accept_word("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept_op(","):
                partition.append(self.expr())
        order_exprs: List[E.Expr] = []
        order_asc: List[bool] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                order_exprs.append(self.expr())
                asc = True
                if self.accept_kw("desc"):
                    asc = False
                else:
                    self.accept_kw("asc")
                order_asc.append(asc)
                if not self.accept_op(","):
                    break
        frame = None
        if self._accept_word("range"):
            raise ParseError("RANGE frames unsupported; use ROWS")
        if self._accept_word("rows"):
            if self.accept_kw("between"):
                lo = self._frame_bound()
                self.expect_kw("and")
                hi = self._frame_bound()
            else:
                lo = self._frame_bound()
                hi = 0
            if lo == "+inf":
                raise ParseError("frame start cannot be UNBOUNDED FOLLOWING")
            if hi == "-inf":
                raise ParseError("frame end cannot be UNBOUNDED PRECEDING")
            lo_v = None if lo == "-inf" else lo
            hi_v = None if hi == "+inf" else hi
            if lo_v is not None and hi_v is not None and lo_v > hi_v:
                raise ParseError("frame start is after frame end")
            if not order_exprs:
                raise ParseError("a ROWS frame requires ORDER BY")
            frame = (lo_v, hi_v)
        self.expect_op(")")
        return partition, order_exprs, order_asc, frame

    def _frame_bound(self):
        """UNBOUNDED PRECEDING|FOLLOWING / CURRENT ROW / N PRECEDING|FOLLOWING
        -> "-inf" / "+inf" / 0 / -N / +N (row offsets relative to current)."""
        if self._accept_word("unbounded"):
            d = self._accept_word("preceding", "following")
            if d is None:
                raise ParseError("expected PRECEDING or FOLLOWING")
            return "-inf" if d == "preceding" else "+inf"
        if self._accept_word("current"):
            self._expect_word("row")
            return 0
        e = self._primary()
        if not isinstance(e, E.Literal) or not isinstance(e.value, int):
            raise ParseError("frame offset must be an integer literal")
        d = self._accept_word("preceding", "following")
        if d is None:
            raise ParseError("expected PRECEDING or FOLLOWING")
        return -e.value if d == "preceding" else e.value

    @staticmethod
    def _fold_neg_literal(d: E.Expr) -> E.Expr:
        """`-3` parses as UnaryOp('-', Literal(3)); literal-argument
        positions (LAG/LEAD defaults, ROUND digits) want the folded form."""
        if (
            isinstance(d, E.UnaryOp)
            and d.op == "-"
            and isinstance(d.operand, E.Literal)
        ):
            return E.Literal(-d.operand.value)
        return d

    def _filter_clause(self) -> Optional[E.Expr]:
        """Optional SQL `FILTER (WHERE <cond>)` after an aggregate call."""
        if not self.accept_kw("filter"):
            return None
        self.expect_op("(")
        self.expect_kw("where")
        cond = self.expr()
        self.expect_op(")")
        return cond

    def _call(self, fn: str) -> E.Expr:
        if fn in (
            "approx_count_distinct_ds_theta",
            "approx_count_distinct_ds_hll",
        ):
            # APPROX_COUNT_DISTINCT_DS_THETA(expr[, k]) /
            # APPROX_COUNT_DISTINCT_DS_HLL(expr[, lgK]) — Druid SQL's
            # DataSketches variants with an explicit size argument
            arg = self.expr()
            extra = ()
            if self.accept_op(","):
                k = self.expr()
                if not isinstance(k, E.Literal) or not isinstance(
                    k.value, int
                ):
                    raise ParseError(f"{fn.upper()} size must be an integer")
                extra = (int(k.value),)
            self.expect_op(")")
            return AggCall(fn, arg, False, self._filter_clause(), extra)
        if fn in ("approx_quantile", "approx_quantile_ds"):
            # APPROX_QUANTILE[_DS](expr, fraction[, k]) — Druid SQL's
            # DataSketches quantile aggregate
            arg = self.expr()
            self.expect_op(",")
            frac = self.expr()
            if not isinstance(frac, E.Literal) or not isinstance(
                frac.value, (int, float)
            ):
                raise ParseError(
                    "APPROX_QUANTILE fraction must be a numeric literal"
                )
            extra = (float(frac.value),)
            if self.accept_op(","):
                k = self.expr()
                if not isinstance(k, E.Literal) or not isinstance(
                    k.value, int
                ):
                    raise ParseError("APPROX_QUANTILE k must be an integer")
                extra = extra + (int(k.value),)
            self.expect_op(")")
            return AggCall(
                "approx_quantile", arg, False, self._filter_clause(), extra
            )
        if fn in AGG_FNS or fn == "count":
            distinct = bool(self.accept_kw("distinct"))
            if self.accept_op("*"):
                arg = None
            elif self.accept_op(")"):
                raise ParseError(f"{fn} requires an argument")
            else:
                arg = self.expr()
            if arg is not None:
                self.expect_op(")")
            else:
                self.expect_op(")")
            return AggCall(fn, arg, distinct, self._filter_clause())
        if fn == "date_trunc":
            gran = self.expr()
            self.expect_op(",")
            arg = self.expr()
            self.expect_op(")")
            if not isinstance(gran, E.Literal):
                raise ParseError("DATE_TRUNC granularity must be a literal")
            return E.TimeBucket(arg, str(gran.value))
        if fn in ("time_floor",):
            arg = self.expr()
            self.expect_op(",")
            gran = self.expr()
            self.expect_op(")")
            return E.TimeBucket(arg, str(gran.value))  # type: ignore[union-attr]
        if fn in ("substr", "substring"):
            arg = self.expr()
            self.expect_op(",")
            start = self.expr()
            length = None
            if self.accept_op(","):
                length = self.expr()
            self.expect_op(")")
            args = (int(start.value),)  # type: ignore[union-attr]
            if length is not None:
                args = args + (int(length.value),)  # type: ignore[union-attr]
            return E.StrFunc("substr", arg, args)
        if fn in ("upper", "lower", "length"):
            arg = self.expr()
            self.expect_op(")")
            return E.StrFunc(fn, arg)
        if fn == "nullif":
            a = self.expr()
            self.expect_op(",")
            b = self.expr()
            self.expect_op(")")
            # NULLIF(a, b) == CASE WHEN a = b THEN NULL ELSE a END
            return E.IfExpr(
                E.Comparison("==", a, b), E.Literal(None), a
            )
        if fn == "concat":
            args = [self.expr()]
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
            cols = [a for a in args if not isinstance(a, E.Literal)]
            lits = [a for a in args if isinstance(a, E.Literal)]
            if any(
                not isinstance(a.value, str) for a in lits
            ):
                raise ParseError("CONCAT literal arguments must be strings")
            if not cols:
                return E.Literal("".join(a.value for a in lits))
            if len(cols) != 1:
                raise ParseError(
                    "CONCAT supports one column operand plus string "
                    "literals (the dictionary-rewrite form)"
                )
            i = args.index(cols[0])
            prefix = "".join(a.value for a in args[:i])
            suffix = "".join(a.value for a in args[i + 1:])
            return E.StrFunc("concat", cols[0], (prefix, suffix))
        if fn == "lookup":
            # LOOKUP(expr, 'name'[, 'replaceMissingValueWith'])
            arg = self.expr()
            self.expect_op(",")
            lname = self.expr()
            replace = None
            if self.accept_op(","):
                replace = self.expr()
            self.expect_op(")")
            if not isinstance(lname, E.Literal) or not isinstance(
                lname.value, str
            ):
                raise ParseError("LOOKUP name must be a string literal")
            args = (lname.value,)
            if replace is not None:
                if not isinstance(replace, E.Literal) or not isinstance(
                    replace.value, str
                ):
                    raise ParseError(
                        "LOOKUP replaceMissingValueWith must be a string "
                        "literal"
                    )
                args = args + (replace.value,)
            return E.StrFunc("lookup", arg, args)
        if fn in ("year", "month", "day", "hour", "minute"):
            arg = self.expr()
            self.expect_op(")")
            return E.TimeExtract(fn, arg)
        if fn in ("abs", "floor", "ceil", "sqrt", "exp", "ln"):
            arg = self.expr()
            self.expect_op(")")
            return E.UnaryOp(fn, arg)
        if fn in ("trim", "ltrim", "rtrim"):
            arg = self.expr()
            self.expect_op(")")
            return E.StrFunc(fn, arg)
        if fn == "replace":
            arg = self.expr()
            self.expect_op(",")
            frm = self.expr()
            self.expect_op(",")
            to = self.expr()
            self.expect_op(")")
            if not (
                isinstance(frm, E.Literal)
                and isinstance(frm.value, str)
                and isinstance(to, E.Literal)
                and isinstance(to.value, str)
            ):
                raise ParseError(
                    "REPLACE search/replacement must be string literals"
                )
            return E.StrFunc("replace", arg, (frm.value, to.value))
        if fn == "round":
            arg = self.expr()
            digits = 0
            if self.accept_op(","):
                d = self._fold_neg_literal(self.expr())
                if not isinstance(d, E.Literal) or not isinstance(
                    d.value, int
                ):
                    raise ParseError(
                        "ROUND digits must be an integer literal"
                    )
                digits = d.value
            self.expect_op(")")
            if digits == 0:
                return E.UnaryOp("round", arg)
            # ROUND(x, d) == ROUND(x * 10^d) / 10^d
            scale = E.Literal(float(10.0 ** digits))
            return E.BinaryOp(
                "/", E.UnaryOp("round", E.BinaryOp("*", arg, scale)), scale
            )
        if fn == "mod":
            a = self.expr()
            self.expect_op(",")
            b = self.expr()
            self.expect_op(")")
            return E.BinaryOp("%", a, b)
        if fn in ("power", "pow"):
            a = self.expr()
            self.expect_op(",")
            b = self.expr()
            self.expect_op(")")
            return E.BinaryOp("pow", a, b)
        if fn == "if":
            # if(cond, then, else) — Druid's native expression form AND the
            # spelling str(IfExpr) serializes to, so expression post-aggs /
            # virtual columns containing CASE round-trip through the wire
            cond = self.expr()
            self.expect_op(",")
            then = self.expr()
            self.expect_op(",")
            otherwise = self.expr()
            self.expect_op(")")
            return E.IfExpr(cond, then, otherwise)
        if fn == "coalesce":
            args = self._expr_list()
            self.expect_op(")")
            out = args[-1]
            for a in reversed(args[:-1]):
                out = E.IfExpr(E.Comparison("!=", a, E.Literal(None)), a, out)
            return out
        if fn == "grouping":
            arg = self.expr()
            self.expect_op(")")
            return GroupingCall(arg)
        if fn in WINDOW_FNS:
            # the OVER clause itself attaches in _maybe_over
            if fn in ("row_number", "rank", "dense_rank",
                      "percent_rank", "cume_dist"):
                self.expect_op(")")
                return WindowCall(fn, None)
            if fn == "ntile":
                k = self.expr()
                self.expect_op(")")
                if not isinstance(k, E.Literal) or not isinstance(
                    k.value, int
                ) or k.value < 1:
                    raise ParseError(
                        "NTILE requires a positive integer literal"
                    )
                return WindowCall(fn, None, (k.value,))
            if fn in ("lag", "lead"):
                arg = self.expr()
                args: tuple = ()
                if self.accept_op(","):
                    off = self.expr()
                    if not isinstance(off, E.Literal) or not isinstance(
                        off.value, int
                    ) or off.value < 0:
                        raise ParseError(
                            f"{fn.upper()} offset must be a non-negative "
                            "integer literal"
                        )
                    args = (off.value,)
                    if self.accept_op(","):
                        d = self._fold_neg_literal(self.expr())
                        if not isinstance(d, E.Literal):
                            raise ParseError(
                                f"{fn.upper()} default must be a literal"
                            )
                        args = args + (d.value,)
                self.expect_op(")")
                return WindowCall(fn, arg, args)
            if fn == "nth_value":
                arg = self.expr()
                self.expect_op(",")
                n = self.expr()
                self.expect_op(")")
                if not isinstance(n, E.Literal) or not isinstance(
                    n.value, int
                ) or n.value < 1:
                    raise ParseError(
                        "NTH_VALUE position must be a positive integer "
                        "literal"
                    )
                return WindowCall(fn, arg, (n.value,))
            # first_value / last_value
            arg = self.expr()
            self.expect_op(")")
            return WindowCall(fn, arg)
        raise ParseError(f"unknown function {fn!r}")


# ---------------------------------------------------------------------------
# Analyzer: SelectStmt -> logical plan
# ---------------------------------------------------------------------------


def _expr_eq(a: E.Expr, b: E.Expr) -> bool:
    return a == b


def _find_group(e: E.Expr, group_keys: Sequence[E.Expr]) -> Optional[int]:
    for i, g in enumerate(group_keys):
        if _expr_eq(e, g):
            return i
    return None


def _contains_agg(e: E.Expr) -> bool:
    # NOTE: deliberately descends into WindowCall specs — an AggCall inside
    # an OVER clause (RANK() OVER (ORDER BY SUM(v))) makes the query an
    # aggregate query, while the window function itself does not
    return E.any_node(e, lambda x: isinstance(x, AggCall))


def _contains_grouping(e: E.Expr) -> bool:
    return E.any_node(e, lambda x: isinstance(x, GroupingCall))


def _contains_window(e: E.Expr) -> bool:
    return E.any_node(e, lambda x: isinstance(x, WindowCall))


def _strip_qualifiers(e: E.Expr, aliases: Dict[str, str]) -> E.Expr:
    """table.col -> col (the engine's datasources are flat); alias tables
    resolve through the FROM-clause alias map."""
    if isinstance(e, E.Col) and "." in e.name:
        return E.Col(e.name.split(".", 1)[1])
    if isinstance(e, (E.Literal, E.AggRef)):
        return e
    kw = {}
    for f in dataclasses.fields(e):  # type: ignore[arg-type]
        v = getattr(e, f.name)
        if isinstance(v, E.Expr):
            kw[f.name] = _strip_qualifiers(v, aliases)
        elif isinstance(v, tuple) and v and isinstance(v[0], E.Expr):
            kw[f.name] = tuple(_strip_qualifiers(x, aliases) for x in v)
        else:
            kw[f.name] = v
    return type(e)(**kw)


class Analyzer:
    """SelectStmt -> logical plan (the Catalyst-analyzer analog)."""

    def __init__(self, stmt: SelectStmt, aliases: Dict[str, str]):
        self.stmt = stmt
        self.aliases = aliases
        self.agg_exprs: List[L.AggExpr] = []
        self.agg_by_key: Dict[str, str] = {}  # str(AggCall) -> assigned name
        self.win_exprs: List[L.WindowExpr] = []
        # GROUPING() substitution context: (group keys, k, has grouping
        # sets) — set by the aggregate path so ORDER BY can substitute too
        self._grouping_ctx: tuple = ([], 0, False)
        # (output name, group-key expr) pairs — window specs over an
        # aggregated frame must reference group keys by their OUTPUT names
        # (GROUP BY g with `g AS grp` yields a frame column `grp`, not `g`)
        self._win_groups: List[Tuple[str, E.Expr]] = []

    def to_logical(self) -> L.LogicalPlan:
        stmt = self.stmt
        self._check_window_positions(stmt)
        base = self._from_clause(stmt.table)
        if stmt.where is not None:
            base = L.Filter(_strip_qualifiers(stmt.where, self.aliases), base)

        has_agg = (
            bool(stmt.group_by)
            or any(_contains_agg(e) for _, e in stmt.items)
            or (stmt.having is not None)
        )
        has_window = any(_contains_window(e) for _, e in stmt.items)
        if stmt.distinct and has_window:
            raise ParseError(
                "SELECT DISTINCT with window functions unsupported"
            )
        if stmt.distinct:
            if has_agg:
                # grouped output rows are already distinct per group in the
                # overwhelmingly common case; deduplicating aggregate values
                # across groups is out of scope (the reference fell back to
                # Spark for it too)
                raise ParseError(
                    "SELECT DISTINCT with GROUP BY / aggregates unsupported"
                )
            # SELECT DISTINCT a, b FROM t == SELECT a, b FROM t GROUP BY a, b
            # (the reference's planner saw the same rewrite from Catalyst)
            if any(
                isinstance(e, E.Col) and e.name == "*" for _, e in stmt.items
            ):
                raise ParseError("SELECT DISTINCT * unsupported")
            stmt = dataclasses.replace(
                stmt,
                distinct=False,
                group_by=[e for _, e in stmt.items],
            )
            self.stmt = stmt
            has_agg = True
        if not has_agg:
            if has_window:
                out_exprs = []
                for alias, e in stmt.items:
                    if isinstance(e, E.Col) and e.name == "*":
                        raise ParseError(
                            "SELECT * cannot be mixed with window functions"
                        )
                    es = _strip_qualifiers(e, self.aliases)
                    name = alias or _auto_name(es)
                    out_exprs.append((name, self._lift_windows(es)))
                plan = L.Window(
                    tuple(self.win_exprs), tuple(out_exprs), base
                )
                return self._order_limit(plan, post_agg=False)
            exprs = []
            for alias, e in stmt.items:
                if isinstance(e, E.Col) and e.name == "*":
                    exprs = []  # SELECT * -> project all (planner fills)
                    break
                e = _strip_qualifiers(e, self.aliases)
                exprs.append((alias or _auto_name(e), e))
            plan: L.LogicalPlan = (
                L.Project(tuple(exprs), base) if exprs else base
            )
            plan = self._order_limit(plan, post_agg=False)
            return plan

        # aggregate query
        group_exprs: List[Tuple[str, E.Expr]] = []
        group_keys: List[E.Expr] = []
        alias_of_item: Dict[str, E.Expr] = {}
        for alias, e in stmt.items:
            if alias is not None:
                alias_of_item[alias] = e
        for ge in stmt.group_by:
            ge = self._resolve_group_ref(ge, stmt.items)
            ge_s = _strip_qualifiers(ge, self.aliases)
            name = None
            for alias, ie in stmt.items:
                if _expr_eq(_strip_qualifiers(ie, self.aliases), ge_s):
                    name = alias or _auto_name(ge_s)
                    break
            group_exprs.append((name or _auto_name(ge_s), ge_s))
            group_keys.append(ge_s)

        # SELECT items -> outputs.  Window-containing items skip the
        # Aggregate's post_exprs entirely: their windows (and any
        # aggregates inside or around them) are computed in an L.Window
        # stage ABOVE the Aggregate/Having, referencing the aggregated
        # frame's group/agg columns.  `out_exprs` preserves SELECT order
        # for the Window stage when one is needed.
        post_exprs: List[Tuple[str, E.Expr]] = []
        out_exprs: List[Tuple[str, E.Expr]] = []
        self._win_groups = list(group_exprs)
        has_sets = stmt.group_mode != "plain"
        k_groups = len(group_exprs)
        self._grouping_ctx = (group_keys, k_groups, has_sets)
        for alias, e in stmt.items:
            es0 = _strip_qualifiers(e, self.aliases)
            had_grouping = _contains_grouping(es0)
            es = self._sub_grouping_calls(es0, group_keys, k_groups, has_sets)
            if _contains_window(es):
                name = alias or _auto_name(es0)
                lifted = self._lift_windows(es)
                if _contains_agg(lifted):
                    lifted = self._lift_aggs(lifted, name, _top=False)
                out_exprs.append((name, self._sub_group_refs(lifted)))
                continue
            if _contains_agg(es) or had_grouping:
                # GROUPING()-containing items are post-aggregate
                # expressions over __grouping_id even without an aggregate
                name = alias or _auto_name(es0)
                post = (
                    self._lift_aggs(es, name) if _contains_agg(es) else es
                )
                post_exprs.append((name, post))
                out_exprs.append((name, E.Col(name)))
            else:
                idx = _find_group(es, group_keys)
                if idx is None:
                    raise ParseError(
                        f"SELECT item {e} is neither aggregated nor grouped"
                    )
                name = alias or group_exprs[idx][0]
                post_exprs.append((name, E.Col(group_exprs[idx][0])))
                out_exprs.append((name, E.Col(name)))

        having_expr = None
        if stmt.having is not None:
            hs = _strip_qualifiers(stmt.having, self.aliases)
            hs = self._sub_grouping_calls(hs, group_keys, k_groups, has_sets)
            having_expr = self._lift_aggs(hs, "having")

        grouping_sets: Tuple[Tuple[int, ...], ...] = ()
        k = len(group_exprs)
        if stmt.group_mode == "cube":
            grouping_sets = tuple(
                tuple(i for i in range(k) if (m >> i) & 1)
                for m in range(1 << k)
            )
        elif stmt.group_mode == "rollup":
            grouping_sets = tuple(
                tuple(range(j)) for j in range(k, -1, -1)
            )
        elif stmt.group_mode == "sets":
            sets = []
            for s in stmt.grouping_sets:
                idxs = []
                for e in s:
                    es = _strip_qualifiers(
                        self._resolve_group_ref(e, stmt.items), self.aliases
                    )
                    i = _find_group(es, group_keys)
                    if i is None:
                        raise ParseError(f"grouping set expr {e} not in GROUP BY")
                    idxs.append(i)
                sets.append(tuple(idxs))
            grouping_sets = tuple(sets)

        plan = L.Aggregate(
            group_exprs=tuple(group_exprs),
            agg_exprs=tuple(self.agg_exprs),
            child=base,
            post_exprs=tuple(post_exprs),
            grouping_sets=grouping_sets,
        )
        if having_expr is not None:
            plan = L.Having(having_expr, plan)
        if self.win_exprs:
            # windows see the post-HAVING aggregated frame (SQL evaluation
            # order: ... HAVING -> window functions -> ORDER BY); a spec
            # referencing an ungrouped, unaggregated source column must be
            # an analysis error, not a runtime KeyError
            valid = (
                {n for n, _ in group_exprs}
                | {ae.name for ae in self.agg_exprs}
                | {n for n, _ in post_exprs}
            )
            for w in self.win_exprs:
                for ex in (w.arg, w.filter, *w.partition, *w.order_exprs):
                    if ex is None:
                        continue
                    for cname in ex.columns():
                        if cname not in valid:
                            raise ParseError(
                                f"window reference {cname!r} is neither "
                                "aggregated nor grouped"
                            )
            plan = L.Window(tuple(self.win_exprs), tuple(out_exprs), plan)
        return self._order_limit(plan, post_agg=True)

    # -- helpers -------------------------------------------------------------

    def _from_clause(self, t) -> L.LogicalPlan:
        if isinstance(t, str):
            return L.Scan(t)
        if isinstance(t, Subquery):
            # the derived table's plan becomes the outer query's leaf,
            # wrapped in a SubqueryScan scope boundary: the outer may only
            # reference the subquery's SELECT-list names (the planner's
            # Project-collapsing walk would otherwise resolve renamed-away
            # names against the base table — silent wrong data)
            if isinstance(t.stmt, UnionStmt):
                # a set-operation view expands here: fold its branches
                names = _stmt_out_names(
                    t.stmt.branches[0], dict(t.aliases)
                )
                return L.SubqueryScan(
                    _union_logical(t.stmt, dict(t.aliases)),
                    tuple(names) if names else None,
                    t.alias,
                )
            inner = Analyzer(t.stmt, dict(t.aliases))
            names = _stmt_out_names(t.stmt, self.aliases)  # [] = SELECT *
            return L.SubqueryScan(
                inner.to_logical(),
                tuple(names) if names else None,
                t.alias,
            )
        assert isinstance(t, JoinClause)
        left = self._from_clause(t.left)
        lk, rk = [], []
        for l, r in t.on:
            lk.append(self._resolve_qualified(l))
            rk.append(self._resolve_qualified(r))
        return L.Join(left, L.Scan(t.right), tuple(lk), tuple(rk), t.how)

    def _resolve_qualified(self, name: str) -> str:
        if "." in name:
            tbl, col = name.split(".", 1)
            tbl = self.aliases.get(tbl, tbl)
            return f"{tbl}.{col}"
        return name

    def _resolve_group_ref(self, ge: E.Expr, items) -> E.Expr:
        # positional GROUP BY 1,2 and alias references
        if isinstance(ge, E.Literal) and isinstance(ge.value, int):
            idx = ge.value - 1
            if not (0 <= idx < len(items)):
                raise ParseError(f"GROUP BY position {ge.value} out of range")
            return items[idx][1]
        if isinstance(ge, E.Col):
            for alias, ie in items:
                if alias == ge.name and not _contains_agg(ie):
                    return ie
        return ge

    def _sub_group_refs(self, e: E.Expr) -> E.Expr:
        """Replace subtrees equal to a GROUP BY key with the key's OUTPUT
        column (no-op outside aggregate queries; aggregates were already
        lifted to AggRefs before this runs).  NOT expressible via
        map_expr: the match is whole-subtree equality against the key
        expression, and map_expr's bottom-up order would rewrite the
        children first and break the comparison."""
        if e is None or not self._win_groups:
            return e
        for name, ge in self._win_groups:
            if e == ge:
                return E.Col(name)
        if isinstance(e, (E.Literal, E.Col, E.AggRef)):
            return e
        kw = {}
        for f in dataclasses.fields(e):  # type: ignore[arg-type]
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                kw[f.name] = self._sub_group_refs(v)
            elif isinstance(v, tuple) and v and isinstance(v[0], E.Expr):
                kw[f.name] = tuple(self._sub_group_refs(x) for x in v)
            else:
                kw[f.name] = v
        return type(e)(**kw)

    def _sub_grouping_calls(
        self, e: E.Expr, group_keys, k: int, has_sets: bool
    ) -> E.Expr:
        """GROUPING(col) -> bit test over __grouping_id (or literal 0 for
        a plain GROUP BY, where nothing is ever rolled away)."""

        def sub(x):
            if not isinstance(x, GroupingCall):
                return x
            arg = _strip_qualifiers(x.col, self.aliases)
            idx = _find_group(arg, group_keys)
            if idx is None:
                raise ParseError(
                    f"GROUPING({x.col}) argument must be a GROUP BY "
                    "expression"
                )
            if not has_sets:
                return E.Literal(0)
            # bit (k-1-idx) of __grouping_id: floor(gid / 2^(k-1-idx)) % 2
            return E.Cast(
                E.BinaryOp(
                    "%",
                    E.UnaryOp(
                        "floor",
                        E.BinaryOp(
                            "/",
                            E.Col("__grouping_id"),
                            E.Literal(float(1 << (k - 1 - idx))),
                        ),
                    ),
                    E.Literal(2.0),
                ),
                "long",
            )

        return E.map_expr(e, sub)

    def _check_window_positions(self, stmt: SelectStmt):
        """Window functions are legal only in the SELECT list (SQL: they
        evaluate after WHERE/GROUP BY/HAVING; ORDER BY must reference the
        SELECT alias)."""
        if stmt.where is not None and _contains_window(stmt.where):
            raise ParseError("window functions are not allowed in WHERE")
        for ge in stmt.group_by:
            if _contains_window(ge):
                raise ParseError("window functions are not allowed in GROUP BY")
        if stmt.having is not None and _contains_window(stmt.having):
            raise ParseError("window functions are not allowed in HAVING")
        for e, _ in stmt.order_by:
            if _contains_window(e):
                raise ParseError(
                    "window functions in ORDER BY: reference the window's "
                    "SELECT alias instead"
                )

    def _lift_windows(self, e: E.Expr, _in_agg_arg: bool = False) -> E.Expr:
        """Replace WindowCall subtrees with hidden-column Col refs,
        accumulating `win_exprs`.  Aggregates inside a window spec (RANK()
        OVER (ORDER BY SUM(v))) lift to hidden agg names so the spec
        evaluates over the aggregated frame."""
        if isinstance(e, WindowCall):
            if _in_agg_arg:
                raise ParseError(
                    "window functions cannot appear inside aggregate "
                    "arguments"
                )

            def inner(x):
                if x is None:
                    return None
                if _contains_window(x):
                    raise ParseError("nested window functions unsupported")
                if _contains_agg(x):
                    x = self._lift_aggs(x, "win", _top=False)
                return self._sub_group_refs(x)

            spec = L.WindowExpr(
                name=f"__win{len(self.win_exprs)}",
                fn=e.fn,
                arg=inner(e.arg),
                args=e.args,
                filter=inner(e.filter),
                partition=tuple(inner(p) for p in e.partition),
                order_exprs=tuple(inner(o) for o in e.order_exprs),
                order_asc=e.order_asc,
                frame=e.frame,
            )
            for w in self.win_exprs:  # dedup identical window calls
                if dataclasses.replace(w, name=spec.name) == spec:
                    return E.Col(w.name)
            self.win_exprs.append(spec)
            return E.Col(spec.name)
        if isinstance(e, (E.Literal, E.Col, E.AggRef)):
            return e
        in_agg = _in_agg_arg or isinstance(e, AggCall)
        kw = {}
        for f in dataclasses.fields(e):  # type: ignore[arg-type]
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                kw[f.name] = self._lift_windows(v, in_agg)
            elif isinstance(v, tuple) and v and isinstance(v[0], E.Expr):
                kw[f.name] = tuple(
                    self._lift_windows(x, in_agg) for x in v
                )
            else:
                kw[f.name] = v
        return type(e)(**kw)

    def _lift_aggs(self, e: E.Expr, hint: str, _top: bool = True) -> E.Expr:
        """Replace AggCall subtrees with AggRefs, accumulating agg_exprs.

        The hint names an aggregate only when it IS the whole item (`_top`);
        aggregates nested inside an expression get hidden `__aggN` names —
        two distinct aggregates under one alias (q14's numerator/denominator
        sums) must not collide on the output name."""
        if isinstance(e, AggCall):
            key = str(e) + (f" FILTER {e.filter}" if e.filter else "")
            if key in self.agg_by_key:
                return E.AggRef(self.agg_by_key[key])
            if _top and _is_simple_output(e, hint):
                name = hint
            else:
                name = f"__agg{len(self.agg_exprs)}"
            fn = e.fn
            if fn == "count" and e.distinct:
                fn = "count_distinct"
            self.agg_exprs.append(
                L.AggExpr(name, fn, e.arg, e.distinct, e.filter, e.args)
            )
            self.agg_by_key[key] = name
            return E.AggRef(name)
        if isinstance(e, (E.Literal, E.Col, E.AggRef)):
            return e
        kw = {}
        for f in dataclasses.fields(e):  # type: ignore[arg-type]
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                kw[f.name] = self._lift_aggs(v, hint, _top=False)
            elif isinstance(v, tuple) and v and isinstance(v[0], E.Expr):
                kw[f.name] = tuple(
                    self._lift_aggs(x, hint, _top=False) for x in v
                )
            else:
                kw[f.name] = v
        return type(e)(**kw)

    def _order_limit(self, plan: L.LogicalPlan, post_agg: bool) -> L.LogicalPlan:
        stmt = self.stmt
        if stmt.order_by:
            keys = []
            for e, asc in stmt.order_by:
                es = _strip_qualifiers(e, self.aliases)
                if _contains_grouping(es):
                    if not post_agg:
                        raise ParseError("GROUPING() requires GROUP BY")
                    es = self._sub_grouping_calls(es, *self._grouping_ctx)
                if post_agg and _contains_agg(es):
                    es = self._lift_aggs(es, _auto_name(es))
                    if not isinstance(es, E.AggRef):
                        raise ParseError(
                            "ORDER BY over aggregate expressions must be "
                            "a plain aggregate or a SELECT alias"
                        )
                elif isinstance(es, E.Literal) and isinstance(es.value, int):
                    idx = es.value - 1
                    alias, ie = stmt.items[idx]
                    es = E.Col(alias or _auto_name(
                        _strip_qualifiers(ie, self.aliases)
                    ))
                keys.append(L.SortKey(es, asc))
            plan = L.Sort(tuple(keys), plan)
        if stmt.limit is not None or stmt.offset:
            plan = L.Limit(
                stmt.limit if stmt.limit is not None else (1 << 62),
                plan,
                stmt.offset,
            )
        return plan


def _is_simple_output(e: AggCall, hint: str) -> bool:
    return not hint.startswith("__")


def _auto_name(e: E.Expr) -> str:
    if isinstance(e, E.Col):
        return e.name
    if isinstance(e, AggCall):
        base = e.fn
        if isinstance(e.arg, E.Col):
            return f"{base}_{e.arg.name}"
        return base
    if isinstance(e, E.TimeBucket):
        return "__time_bucket"
    s = "".join(ch if ch.isalnum() else "_" for ch in str(e))[:40]
    return f"expr_{s}" if s else "expr"


def _stmt_out_names(stmt: SelectStmt, aliases) -> List[str]:
    out_names: List[str] = []
    for alias, e in stmt.items:
        if isinstance(e, E.Col) and e.name == "*":
            return []
        es = _strip_qualifiers(e, aliases)
        out_names.append(alias or _auto_name(es))
    return out_names


#: set operations that are associative — consecutive same-op branches
#: flatten into one n-ary Union node (EXCEPT is not associative: it stays
#: strictly binary under the standard left fold)
_ASSOCIATIVE_SETOPS = {"union_all", "union", "intersect", "intersect_all"}


def _fold_setops(plans, ops) -> L.LogicalPlan:
    """Fold a flat set-operation chain into a logical tree with SQL
    precedence: INTERSECT [ALL] binds tighter than UNION/EXCEPT, all
    left-associative.  `A UNION B INTERSECT C` == `A UNION (B INTERSECT C)`."""

    def join(left: L.LogicalPlan, op: str, right: L.LogicalPlan):
        if (
            op in _ASSOCIATIVE_SETOPS
            and isinstance(left, L.Union)
            and left.op == op
        ):
            return L.Union(left.branches + (right,), op=op)
        return L.Union((left, right), op=op)

    # pass 1: bind INTERSECT [ALL] runs
    terms = [plans[0]]
    term_ops = []
    for op, p in zip(ops, plans[1:]):
        if op.startswith("intersect"):
            terms[-1] = join(terms[-1], op, p)
        else:
            term_ops.append(op)
            terms.append(p)
    # pass 2: left fold UNION / EXCEPT
    plan = terms[0]
    for op, p in zip(term_ops, terms[1:]):
        plan = join(plan, op, p)
    return plan


def parse_sql(
    sql: str, views: Optional[Dict[str, str]] = None
) -> Tuple[L.LogicalPlan, bool, List[str]]:
    """Returns (logical plan, explain?, SELECT-order output names).
    `views` maps view names to their defining SELECT text (CREATE VIEW)."""
    p = Parser(sql, views=views)
    stmt = p.parse()
    if isinstance(stmt, UnionStmt):
        plan = _union_logical(stmt, p.aliases)
        return (
            plan,
            stmt.explain,
            _stmt_out_names(stmt.branches[0], p.aliases),
        )
    analyzer = Analyzer(stmt, p.aliases)
    plan = analyzer.to_logical()
    return plan, stmt.explain, _stmt_out_names(stmt, p.aliases)


def _union_logical(stmt: UnionStmt, aliases) -> L.LogicalPlan:
    """UnionStmt -> folded logical tree with trailing ORDER BY / LIMIT."""
    plans = [
        Analyzer(b, dict(aliases)).to_logical() for b in stmt.branches
    ]
    plan = _fold_setops(plans, stmt.ops)
    first = stmt.branches[0]
    if stmt.order_by:
        # mirror Analyzer._order_limit's resolution: ordinals bind to
        # the first branch's SELECT items; aggregates have no grouping
        # context after UNION ALL and are rejected, not crashed on
        keys = []
        for e, asc in stmt.order_by:
            es = _strip_qualifiers(e, aliases)
            if _contains_agg(es) or _contains_window(es):
                raise ParseError(
                    "ORDER BY after a set operation must reference "
                    "output columns, not aggregates or window functions"
                )
            if isinstance(es, E.Literal) and isinstance(es.value, int):
                idx = es.value - 1
                if not 0 <= idx < len(first.items):
                    raise ParseError(
                        f"ORDER BY ordinal {es.value} out of range"
                    )
                alias, ie = first.items[idx]
                es = E.Col(
                    alias or _auto_name(_strip_qualifiers(ie, aliases))
                )
            keys.append(L.SortKey(es, asc))
        plan = L.Sort(tuple(keys), plan)
    if stmt.limit is not None or stmt.offset:
        plan = L.Limit(
            stmt.limit if stmt.limit is not None else (1 << 62),
            plan,
            stmt.offset,
        )
    return plan
