"""Scalar expression tree + compiler to element-wise tensor functions.

Expressions carry the arithmetic of expression aggregates, virtual columns
and residual filters (Druid's JavaScript slot).  `compile_expr` turns a tree
into `fn(columns) -> tensor` over device-resident columns; PyTorch runs the
ops eagerly on whatever device the columns live on.

Types follow the reference package exactly where it matters for parity:
metric columns are float32 and arithmetic on them stays float32 (a Python
literal does not promote a float32 tensor), numeric-dictionary dimensions
decode to int64 values, and time is int64 milliseconds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch


class Expr:
    def __add__(self, o):
        return BinaryOp("+", self, _lit(o))

    def __radd__(self, o):
        return BinaryOp("+", _lit(o), self)

    def __sub__(self, o):
        return BinaryOp("-", self, _lit(o))

    def __rsub__(self, o):
        return BinaryOp("-", _lit(o), self)

    def __mul__(self, o):
        return BinaryOp("*", self, _lit(o))

    def __rmul__(self, o):
        return BinaryOp("*", _lit(o), self)

    def __truediv__(self, o):
        return BinaryOp("/", self, _lit(o))

    def __rtruediv__(self, o):
        return BinaryOp("/", _lit(o), self)

    def __neg__(self):
        return UnaryOp("-", self)

    def __gt__(self, o):
        return Comparison(">", self, _lit(o))

    def __ge__(self, o):
        return Comparison(">=", self, _lit(o))

    def __lt__(self, o):
        return Comparison("<", self, _lit(o))

    def __le__(self, o):
        return Comparison("<=", self, _lit(o))

    def eq(self, o):
        return Comparison("==", self, _lit(o))

    def ne(self, o):
        return Comparison("!=", self, _lit(o))

    def and_(self, o):
        return BoolOp("and", (self, _lit(o)))

    def or_(self, o):
        return BoolOp("or", (self, _lit(o)))

    def not_(self):
        return BoolOp("not", (self,))

    __and__ = and_
    __or__ = or_
    __invert__ = not_

    def isin(self, values):
        return InExpr(self, tuple(values))

    def between(self, lo, hi):
        return BoolOp("and", (Comparison(">=", self, _lit(lo)),
                              Comparison("<=", self, _lit(hi))))

    def columns(self) -> Tuple[str, ...]:
        """All column names referenced."""
        out: list = []
        _collect_cols(self, out)
        return tuple(dict.fromkeys(out))


def apply_strfunc(fn: str, args: tuple, s: str):
    """One string-function application over a non-null string (dictionary
    rewrites in models/dimensions.py)."""
    if fn == "upper":
        return s.upper()
    if fn == "lower":
        return s.lower()
    if fn == "substr":
        start = int(args[0]) - 1  # SQL is 1-based
        if len(args) > 1:
            return s[start : start + int(args[1])]
        return s[start:]
    if fn == "concat":
        return f"{args[0]}{s}{args[1]}"
    if fn == "length":
        return len(s)
    # Druid / standard SQL TRIM strips SPACES only (chars=' '), not all
    # whitespace — a trailing tab survives
    if fn == "trim":
        return s.strip(" ")
    if fn == "ltrim":
        return s.lstrip(" ")
    if fn == "rtrim":
        return s.rstrip(" ")
    if fn == "replace":
        return s.replace(str(args[0]), str(args[1]))
    raise ValueError(f"unsupported string fn {fn!r}")


def map_expr(e, fn):
    """Bottom-up structural map over an expression tree: children are
    mapped first, the node is rebuilt, then `fn` transforms the result.
    The one place that knows how Expr dataclasses hold children (direct
    Expr fields and tuples of Exprs).  Opaque fields (a subquery's `stmt`)
    are not descended."""
    if not isinstance(e, Expr):
        return e
    kw = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            kw[f.name] = map_expr(v, fn)
        elif isinstance(v, tuple) and v and isinstance(v[0], Expr):
            kw[f.name] = tuple(map_expr(x, fn) for x in v)
    return fn(dataclasses.replace(e, **kw) if kw else e)


def any_node(e, pred) -> bool:
    """True when `pred` holds for any node of an expression tree (the
    read-only sibling of `map_expr`)."""
    if not isinstance(e, Expr):
        return False
    if pred(e):
        return True
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            if any_node(v, pred):
                return True
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, Expr) and any_node(x, pred):
                    return True
    return False


def _collect_cols(e: Expr, out: list):
    if isinstance(e, Col):
        out.append(e.name)
    refs = getattr(e, "outer_refs", None)
    if refs:
        # a correlated subquery reads outer columns by their bare names
        out.extend(_outer_bare(refs))
    for f in dataclasses.fields(e):  # type: ignore[arg-type]
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            _collect_cols(v, out)
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, Expr):
                    _collect_cols(x, out)


def _lit(x) -> Expr:
    return x if isinstance(x, Expr) else Literal(x)


@dataclasses.dataclass(frozen=True, eq=True)
class Col(Expr):
    name: str

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=True)
class Literal(Expr):
    value: Any

    def __str__(self):
        # str() output must re-parse under the SQL expression grammar (the
        # wire form of expression aggregates)
        if self.value is None:
            return "null"
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=True)
class BinaryOp(Expr):
    op: str  # + - * / % pow
    left: Expr
    right: Expr

    def __str__(self):
        if self.op == "pow":
            return f"pow({self.left}, {self.right})"
        return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(frozen=True, eq=True)
class UnaryOp(Expr):
    op: str  # - abs floor ceil sqrt exp ln round
    operand: Expr

    def __str__(self):
        return f"{self.op}({self.operand})"


@dataclasses.dataclass(frozen=True, eq=True)
class Comparison(Expr):
    op: str  # > >= < <= == !=
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclasses.dataclass(frozen=True, eq=True)
class BoolOp(Expr):
    op: str  # and or not
    operands: Tuple[Expr, ...]

    def __str__(self):
        if self.op == "not":
            return f"not({self.operands[0]})"
        return "(" + f" {self.op} ".join(str(o) for o in self.operands) + ")"


@dataclasses.dataclass(frozen=True, eq=True)
class InExpr(Expr):
    operand: Expr
    values: Tuple[Any, ...]

    def __str__(self):
        return f"({self.operand} in {self.values})"


def _outer_bare(outer_refs) -> tuple:
    """Bare outer column names a correlated subquery reads (its outer refs
    are qualified, `alias.col`)."""
    return tuple(q.split(".", 1)[1] for q in (outer_refs or ()))


@dataclasses.dataclass(frozen=True, eq=True)
class InSubquery(Expr):
    """`x IN (SELECT c FROM ...)`, a semi-join.  The planner rejects every
    subquery with a RewriteError; the parser still builds the node so the
    logical plan matches the reference's.  `stmt` is a sql.parser.SelectStmt
    (typed Any to keep plan/ independent of the SQL layer); `outer_refs`
    (qualified outer columns) marks correlation."""

    operand: Expr
    stmt: Any
    aliases: Any = None  # alias->table mapping captured at parse time
    outer_refs: Any = None  # tuple of "alias.col" correlation references

    def columns(self):
        return tuple(self.operand.columns()) + _outer_bare(self.outer_refs)

    def __str__(self):
        # the id keeps two different subqueries apart under the analyzer's
        # string-keyed aggregate dedup
        return f"({self.operand} IN (<subquery#{id(self.stmt):x}>))"


@dataclasses.dataclass(frozen=True, eq=True)
class ExistsSubquery(Expr):
    """`EXISTS (SELECT ...)`."""

    stmt: Any
    aliases: Any = None
    outer_refs: Any = None

    def columns(self):
        return _outer_bare(self.outer_refs)

    def __str__(self):
        return f"EXISTS(<subquery#{id(self.stmt):x}>)"


@dataclasses.dataclass(frozen=True, eq=True)
class ScalarSubquery(Expr):
    """`(SELECT agg FROM ...)` in expression position."""

    stmt: Any
    aliases: Any = None
    outer_refs: Any = None

    def columns(self):
        return _outer_bare(self.outer_refs)

    def __str__(self):
        return f"(<scalar subquery#{id(self.stmt):x}>)"


@dataclasses.dataclass(frozen=True, eq=True)
class IfExpr(Expr):
    cond: Expr
    then: Expr
    otherwise: Expr

    def __str__(self):
        return f"if({self.cond}, {self.then}, {self.otherwise})"


@dataclasses.dataclass(frozen=True, eq=True)
class Cast(Expr):
    operand: Expr
    to: str  # "double" | "long" | "bool"

    def __str__(self):
        return f"cast({self.operand} as {self.to})"


@dataclasses.dataclass(frozen=True, eq=True)
class TimeBucket(Expr):
    """floor(__time to granularity).  In a GROUP BY position it becomes a
    time DimensionSpec (exact for calendar granularities); on the row path it
    compiles to int64 arithmetic, which requires a fixed period."""

    operand: Expr
    granularity: str  # "hour", "month", ISO period, ...

    @property
    def period_ms(self) -> Optional[int]:
        from ..utils.granularity import granularity_period_ms

        return granularity_period_ms(self.granularity)

    def __str__(self):
        return f"time_floor({self.operand}, {self.granularity})"


@dataclasses.dataclass(frozen=True, eq=True)
class LikeExpr(Expr):
    """SQL LIKE — translatable to a dictionary-evaluated code set on dims."""

    operand: Expr
    pattern: str
    negated: bool = False

    def __str__(self):
        return f"({self.operand} {'NOT ' if self.negated else ''}LIKE {self.pattern!r})"


@dataclasses.dataclass(frozen=True, eq=True)
class StrFunc(Expr):
    """String function over a dimension — only legal in GROUP BY / filter
    positions, where it becomes a host-side dictionary rewrite; never
    row-path device code."""

    fn: str  # substr | upper | lower
    operand: Expr
    args: Tuple[Any, ...] = ()

    def __str__(self):
        a = ", ".join(str(x) for x in (self.operand,) + self.args)
        return f"{self.fn}({a})"


@dataclasses.dataclass(frozen=True, eq=True)
class TimeExtract(Expr):
    """EXTRACT(field FROM time): civil-calendar integer arithmetic on the
    int64 ms column."""

    field: str  # year | month | day | hour | minute | second
    operand: Expr

    def __str__(self):
        return f"extract({self.field} from {self.operand})"


@dataclasses.dataclass(frozen=True, eq=True)
class AggRef(Expr):
    """Reference to an aggregation output by name (HAVING / post-aggs)."""

    name: str

    def __str__(self):
        return f"agg:{self.name}"


class DeviceConst:
    """A host numpy constant (code set, remap table, bucket starts) that
    compiled functions read on whatever device the columns live on.  The
    device copy is made once per device and kept: a CUDA graph's capture
    makes it in its warm-up run, and the graph only reads it."""

    def __init__(self, host: np.ndarray):
        self.host = np.ascontiguousarray(host)
        self._on = {}
        self._sorted = None

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.host).to(device)
            self._on[device] = t
        return t

    def sorted(self) -> "DeviceConst":
        """The distinct values in ascending order, as a constant of its own."""
        if self._sorted is None:
            self._sorted = DeviceConst(np.unique(self.host))
        return self._sorted


def as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A compiled sub-expression may yield a Python scalar (a literal);
    lift it to a 0-d tensor on `like`'s device.  The tensor is filled on the
    device (`torch.full`), not copied from the host: a copy would sync the
    host and could not be captured in a CUDA graph."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, device=None if like is None else like.device)
    return torch.as_tensor(x, device=None if like is None else like.device)


def isin(x: torch.Tensor, values: DeviceConst) -> torch.Tensor:
    """Membership of each element of `x` in a constant set, by a binary
    search of the set's sorted values.  `torch.isin` sorts and deduplicates
    on the device above a few dozen values, which syncs the host; the search
    never does.  Integer and float operands compare in their common dtype."""
    v = values.sorted().on(x.device)
    if v.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    dt = torch.promote_types(x.dtype, v.dtype)
    x, v = x.to(dt), v.to(dt)
    hit = v[torch.searchsorted(v, x).clamp_(max=v.numel() - 1)]
    return hit == x


def _false_like(x) -> torch.Tensor:
    x = as_tensor(x)
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device)


def _round_half_away(x):
    # SQL ROUND is half-away-from-zero; torch.round is half-to-even
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


_UNARY = {
    "-": lambda x: -x,
    "abs": torch.abs,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "ln": torch.log,
    "round": _round_half_away,
}

_BINARY = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,  # floor-mod on tensors, like Python's
    "pow": lambda a, b: a ** b,
}

_CMP = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


_FLIP = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "==": "==", "!=": "!="}


def coerce_str_literal(s: str) -> Optional[float]:
    """Numeric value for a string literal compared against a numeric/time
    column: plain number, or ISO date/timestamp -> epoch ms.  None when
    neither parse applies."""
    try:
        return float(s)
    except (TypeError, ValueError):
        pass
    try:
        return float(np.datetime64(s, "ms").astype(np.int64))
    except ValueError:
        return None


def _is_string_dict(dicts, name: str) -> bool:
    d = dicts.get(name) if dicts else None
    return d is not None and d.numeric_values is None


def codes(cols, name: str) -> torch.Tensor:
    """Dictionary codes widened to int32.  Codes are stored at int8/int16
    (catalog.segment.code_dtype), and a comparison of a narrow tensor with
    a Python int outside its range wraps silently in torch (int8 >= 128 is
    int8 >= -128), so every code-space test reads the widened column."""
    return cols[name].to(torch.int32)


def _compile_str_comparison(e: "Comparison", dicts):
    """Handle `Col <op> 'literal'` (either orientation).  Returns a compiled
    fn, a numeric rewrite of the expression, or None when no string literal
    is involved.  Raises on unresolvable string comparisons."""
    if isinstance(e.right, Literal) and isinstance(e.left, Col):
        name, litv, op = e.left.name, e.right.value, e.op
    elif isinstance(e.left, Literal) and isinstance(e.right, Col):
        name, litv, op = e.right.name, e.left.value, _FLIP[e.op]
    else:
        return None
    if not isinstance(litv, str):
        return None
    d = dicts.get(name) if dicts else None
    if d is not None and d.numeric_values is None:
        # Sorted string dictionary: codes are order-preserving ranks, so
        # every comparison translates to integer code space; null codes
        # (-1) never satisfy any predicate.
        def raw(cols):
            return codes(cols, name)

        if op == "==":
            code = d.code_of(litv)
            if code is None:
                return lambda cols: _false_like(raw(cols))
            return lambda cols: raw(cols) == code
        if op == "!=":
            code = d.code_of(litv)
            if code is None:
                return lambda cols: raw(cols) >= 0
            return lambda cols: (raw(cols) >= 0) & (raw(cols) != code)
        vals = np.asarray(d.values, dtype=str)
        if op in (">", ">="):
            lo = int(np.searchsorted(vals, litv, side="right" if op == ">" else "left"))
            return lambda cols: raw(cols) >= lo
        hi = int(np.searchsorted(vals, litv, side="left" if op == "<" else "right")) - 1
        if hi < 0:
            return lambda cols: _false_like(raw(cols))
        return lambda cols: (raw(cols) >= 0) & (raw(cols) <= hi)
    # Numeric-dictionary / metric / time column vs string literal: coerce the
    # literal (numeric string or ISO date) and rewrite as a numeric compare —
    # expression columns arrive value-decoded via DecodedView.
    v = coerce_str_literal(litv)
    if v is None:
        raise ValueError(
            f"cannot compare column {name!r} against string literal {litv!r}: "
            "not a dictionary dimension and the literal is neither numeric "
            "nor an ISO date"
        )
    return Comparison(op, Col(name), Literal(int(v) if v == int(v) else v))


def _null_guarded(base, name: str):
    """AND the compiled comparison with `raw codes >= 0` for a numeric-dict
    dimension: DecodedView decodes null codes (-1) to -1, which would
    otherwise satisfy <, <=, != predicates (SQL: NULL compare excludes)."""

    def fn(cols, base=base, name=name):
        m = base(cols)
        raw = getattr(cols, "raw", None)
        if raw is not None:
            m = m & (raw(name) >= 0)
        return m

    return fn


def _compile_comparison(e: "Comparison", dicts):
    """Numeric/generic comparison compile: f32 columns vs f64 literals get
    exact double semantics via host-adjusted thresholds (utils/floatcmp);
    everything else is an elementwise compare."""

    def _num_lit(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    # SQL: an ordering comparison with NULL is UNKNOWN -> matches nothing.
    # Equality stays: `== Literal(None)` is the IS NULL encoding.
    if e.op in (">", ">=", "<", "<=") and any(
        isinstance(s, Literal) and s.value is None for s in (e.left, e.right)
    ):
        other = e.right if (
            isinstance(e.left, Literal) and e.left.value is None
        ) else e.left
        of = compile_expr(other, dicts)
        return lambda cols, of=of: _false_like(of(cols))

    lit_side = None
    if isinstance(e.right, Literal) and _num_lit(e.right.value):
        lit_side, lit_val, other = "right", e.right.value, e.left
    elif isinstance(e.left, Literal) and _num_lit(e.left.value):
        lit_side, lit_val, other = "left", e.left.value, e.right
    if lit_side is not None and e.op in (">", ">=", "<", "<=", "==", "!="):
        from ..utils.floatcmp import f32_adjusted_compare

        of = compile_expr(other, dicts)
        op_name = e.op
        if lit_side == "left" and op_name in (">", ">=", "<", "<="):
            op_name = _FLIP[op_name]
        # all threshold adjustment precomputed at compile time
        cmp32 = f32_adjusted_compare(op_name, float(lit_val))

        def cmp_fn(cols, of=of, op_name=op_name, lit_val=lit_val, cmp32=cmp32):
            x = as_tensor(of(cols))
            if x.dtype == torch.float32:
                return cmp32(x)
            if not x.dtype.is_floating_point and lit_val != int(lit_val):
                # an integer column against a fractional literal: compare
                # in float64 (a Python float would not widen the tensor)
                x = x.to(torch.float64)
            return _CMP[op_name](x, lit_val)

        return cmp_fn
    lf = compile_expr(e.left, dicts)
    rf = compile_expr(e.right, dicts)
    op = _CMP[e.op]
    return lambda cols: op(lf(cols), rf(cols))


def compile_expr(
    e: Expr, dicts: Optional[Mapping[str, Any]] = None
) -> Callable[[Mapping[str, Any]], Any]:
    """Compile an Expr tree into `fn(columns_dict) -> tensor`.

    The returned function is pure and shape-preserving: it maps a dict of
    row-aligned column tensors to one tensor (or a Python scalar for a
    literal-only expression).

    `dicts` (dimension name -> DimensionDict) enables string-literal
    comparisons over dictionary-encoded dimensions: equality/ranges translate
    into integer code space at compile time (sorted dicts make codes
    order-preserving).  Without it, any string comparison raises.
    """
    if isinstance(e, Col):
        name = e.name
        return lambda cols: cols[name]
    if isinstance(e, Literal):
        v = e.value
        return lambda cols: v
    if isinstance(e, BinaryOp):
        lf = compile_expr(e.left, dicts)
        rf = compile_expr(e.right, dicts)
        op = _BINARY[e.op]
        return lambda cols: op(lf(cols), rf(cols))
    if isinstance(e, UnaryOp):
        f = compile_expr(e.operand, dicts)
        op = _UNARY[e.op]
        return lambda cols: op(as_tensor(f(cols)))
    if isinstance(e, Comparison):
        sc = _compile_str_comparison(e, dicts)
        if isinstance(sc, Comparison):
            e = sc  # coerced to a numeric compare; fall through
        elif sc is not None:
            return sc
        for side in (e.left, e.right):
            if isinstance(side, Literal) and isinstance(side.value, str):
                raise ValueError(
                    f"unresolvable string comparison {e}: string literals "
                    "require a bare dictionary-dimension column on the "
                    "other side (pass `dicts` from the datasource)"
                )
        for side in (e.left, e.right):
            if isinstance(side, Col) and _is_string_dict(dicts, side.name):
                raise ValueError(
                    f"comparison {e} reads string-dictionary column "
                    f"{side.name!r} in value position; only `dim <op> "
                    "'literal'` comparisons are translatable to code space"
                )
        # numeric-dict dims decode nulls to -1 (DecodedView); a bare
        # `dim <op> literal` compare must not let null rows satisfy the
        # predicate (SQL: NULL compare -> NULL -> excluded)
        guard_col = None
        for side, other in ((e.left, e.right), (e.right, e.left)):
            if (
                isinstance(side, Col)
                and isinstance(other, Literal)
                and dicts
                and side.name in dicts
                and dicts[side.name].numeric_values is not None
            ):
                guard_col = side.name
        if guard_col is not None:
            return _null_guarded(_compile_comparison(e, dicts), guard_col)
        return _compile_comparison(e, dicts)
    if isinstance(e, BoolOp):
        fs = [compile_expr(o, dicts) for o in e.operands]
        if e.op == "not":
            f0 = fs[0]
            return lambda cols: torch.logical_not(as_tensor(f0(cols)))
        if e.op == "and":
            return lambda cols: _fold(torch.logical_and, fs, cols)
        return lambda cols: _fold(torch.logical_or, fs, cols)
    if isinstance(e, InExpr):
        if any(isinstance(v, str) for v in e.values):
            if not isinstance(e.operand, Col):
                raise ValueError(
                    f"IN over string values requires a bare column: {e}"
                )
            name = e.operand.name
            if _is_string_dict(dicts, name):
                d = dicts[name]
                cs = np.array(
                    [c for c in (d.code_of(v) for v in e.values) if c is not None],
                    dtype=np.int32,
                )
                if len(cs) == 0:
                    return lambda cols: _false_like(cols[name])
                const = DeviceConst(cs)
                return lambda cols: isin(codes(cols, name), const)
            coerced = []
            for v in e.values:
                c = coerce_str_literal(v) if isinstance(v, str) else float(v)
                if c is None:
                    raise ValueError(
                        f"IN value {v!r} over non-dictionary column {name!r} "
                        "is neither numeric nor an ISO date"
                    )
                coerced.append(c)
            vals = np.asarray(coerced)
            vals = vals.astype(np.int64) if (vals == vals.astype(np.int64)).all() else vals
            const = DeviceConst(vals)
            return lambda cols: _isin_value(cols[name], const)
        f = compile_expr(e.operand, dicts)
        const = DeviceConst(np.asarray(e.values))
        return lambda cols: _isin_value(as_tensor(f(cols)), const)
    if isinstance(e, IfExpr):
        cf = compile_expr(e.cond, dicts)
        tf = compile_expr(e.then, dicts)
        of = compile_expr(e.otherwise, dicts)

        def if_fn(cols):
            c = as_tensor(cf(cols))
            return torch.where(
                c.to(torch.bool), as_tensor(tf(cols), c), as_tensor(of(cols), c)
            )

        return if_fn
    if isinstance(e, Cast):
        f = compile_expr(e.operand, dicts)
        dt = {"double": torch.float32, "long": torch.int32, "bool": torch.bool}[e.to]
        return lambda cols: as_tensor(f(cols)).to(dt)
    if isinstance(e, TimeBucket):
        f, p = compile_expr(e.operand, dicts), e.period_ms
        if p is None:
            raise ValueError(
                f"calendar granularity {e.granularity!r} has no fixed period; "
                "only legal in GROUP BY position (dimension bucketing)"
            )
        return lambda cols: (as_tensor(f(cols)) // p * p).to(torch.int64)
    if isinstance(e, TimeExtract):
        if e.field not in _EXTRACT_FIELDS:
            raise ValueError(
                f"EXTRACT field {e.field!r}; supported: {sorted(_EXTRACT_FIELDS)}"
            )
        f, field = compile_expr(e.operand, dicts), e.field
        return lambda cols: _time_extract(as_tensor(f(cols)), field)
    if isinstance(e, LikeExpr):
        if isinstance(e.operand, Col) and _is_string_dict(
            dicts, e.operand.name
        ):
            # shared dictionary->code-set translation (ops/filters.py): the
            # pattern runs over the dictionary once at compile time; the
            # device sees a code-set membership test
            from ..ops.filters import like_match_codes

            cs = like_match_codes(dicts[e.operand.name], e.pattern)
            name, neg = e.operand.name, e.negated
            if len(cs) == 0:
                if neg:  # NOT LIKE matching nothing = all non-null rows
                    return lambda cols: cols[name] >= 0
                return lambda cols: _false_like(cols[name])
            const = DeviceConst(cs)
            if neg:  # SQL: NULL NOT LIKE p is NULL -> excluded
                return lambda cols: (cols[name] >= 0) & ~isin(
                    codes(cols, name), const
                )
            return lambda cols: isin(codes(cols, name), const)
        raise ValueError(
            "LIKE over a non-dictionary operand cannot compile to a device "
            "row expression (dictionary dimensions translate to code sets)"
        )
    if isinstance(e, StrFunc):
        raise ValueError(
            "StrFunc is dictionary-evaluated (filter / GROUP BY "
            "position only); it cannot compile to a device row expression"
        )
    if isinstance(e, AggRef):
        name = e.name
        return lambda cols: cols[name]
    raise TypeError(f"cannot compile expression {e!r}")


def _isin_value(x: torch.Tensor, values: DeviceConst) -> torch.Tensor:
    """Value-space membership: compare in float64 when either side is
    fractional, so an f32 column never rounds a literal into a match."""
    if x.dtype.is_floating_point or values.host.dtype.kind == "f":
        x = x.to(torch.float64)
    return isin(x, values)


def _fold(op, fs, cols):
    acc = as_tensor(fs[0](cols))
    for f in fs[1:]:
        acc = op(acc, as_tensor(f(cols), acc))
    return acc


_EXTRACT_FIELDS = {"year", "month", "day", "hour", "minute", "second"}


def _time_extract(t_ms: torch.Tensor, field: str):
    """Civil-calendar field from int64 epoch-ms — pure integer ops;
    days-to-(y,m,d) via the standard era/cycle decomposition."""
    if field == "second":
        return ((t_ms // 1_000) % 60).to(torch.int32)
    if field == "minute":
        return ((t_ms // 60_000) % 60).to(torch.int32)
    if field == "hour":
        return ((t_ms // 3_600_000) % 24).to(torch.int32)
    days = t_ms // 86_400_000
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(y.dtype)
    if field == "year":
        return y.to(torch.int32)
    if field == "month":
        return m.to(torch.int32)
    if field == "day":
        return d.to(torch.int32)
    raise ValueError(f"EXTRACT field {field!r}")


_UNARY_NP = {
    "-": np.negative,
    "abs": np.abs,
    "floor": np.floor,
    "ceil": np.ceil,
    "sqrt": np.sqrt,
    "exp": np.exp,
    "ln": np.log,
    "round": lambda x: np.sign(x) * np.floor(np.abs(x) + 0.5),
}


def _host_valid(xo: np.ndarray, kind) -> np.ndarray:
    """Rows of an object column that hold a value of `kind` (SQL
    three-valued logic: NULL never satisfies a comparison)."""
    if kind is str:
        return np.array([isinstance(v, str) for v in xo], dtype=bool)
    return np.array(
        [
            isinstance(v, (int, float))
            and not isinstance(v, bool)
            and not (isinstance(v, float) and np.isnan(v))
            for v in xo
        ],
        dtype=bool,
    )


def _compile_host_comparison(e: "Comparison"):
    lit = {s: x for s, x in (("left", e.left), ("right", e.right))
           if isinstance(x, Literal)}
    if any(v.value is None for v in lit.values()):
        other = e.right if "left" in lit and lit["left"].value is None else e.left
        of = compile_host_expr(other)
        if e.op in (">", ">=", "<", "<="):
            return lambda cols: np.zeros(np.shape(np.asarray(of(cols))), bool)
        # IS [NOT] NULL: nulls are None (object columns) or NaN (metrics)
        import pandas as pd

        eq = e.op == "=="

        def isnull(cols):
            isn = np.asarray(pd.isna(np.asarray(of(cols))))
            return isn if eq else ~isn

        return isnull
    num = {s: x.value for s, x in lit.items()
           if isinstance(x.value, (int, float)) and not isinstance(x.value, bool)}
    if num:
        from ..utils.floatcmp import f32_adjusted_compare

        side = "right" if "right" in num else "left"
        lit_val = num[side]
        of = compile_host_expr(e.left if side == "right" else e.right)
        op = e.op if side == "right" else _FLIP[e.op]
        cmp32 = f32_adjusted_compare(op, float(lit_val))

        def cmp_num(cols):
            x = np.asarray(of(cols))
            if x.dtype.kind == "O":
                valid = _host_valid(x, float)
                res = np.zeros(x.shape, dtype=bool)
                if valid.any():
                    res[valid] = _CMP[op](x[valid].astype(np.float64), lit_val)
                return res
            if x.dtype == np.float32:
                return cmp32(torch.from_numpy(np.ascontiguousarray(x))).numpy()
            return _CMP[op](x, lit_val)

        return cmp_num
    lf, rf = compile_host_expr(e.left), compile_host_expr(e.right)
    op = _CMP[e.op]
    strs = {s: x.value for s, x in lit.items() if isinstance(x.value, str)}
    if not strs:
        return lambda cols: op(np.asarray(lf(cols)), np.asarray(rf(cols)))
    flip = "left" in strs
    str_lit = strs["left" if flip else "right"]
    of = rf if flip else lf
    numv = coerce_str_literal(str_lit)

    def cmp_mixed(cols):
        # a string literal against a numeric column (time ms vs an ISO
        # date) coerces; against decoded strings it compares as text
        x = np.asarray(of(cols))
        if x.dtype.kind in ("i", "u", "f") and numv is not None:
            return op(numv, x) if flip else op(x, numv)
        if x.dtype.kind == "O":
            valid = _host_valid(x, str)
            res = np.zeros(x.shape, dtype=bool)
            if valid.any():
                vx = x[valid].astype(str)
                res[valid] = op(str_lit, vx) if flip else op(vx, str_lit)
            return res
        return op(str_lit, x) if flip else op(x, str_lit)

    return cmp_mixed


def compile_host_expr(e: Expr) -> Callable[[Mapping[str, Any]], Any]:
    """Compile an Expr into `fn(columns) -> numpy array` over a result
    table on the host: decoded dimension values (strings, or Python ints
    with None for null) and float64 metrics.  This is what HAVING residues
    and post-expressions run on after finalize (the JAX package's
    `compile_expr(..., raw_strings=True)`), with the same null and string
    semantics."""
    if isinstance(e, (Col, AggRef)):
        name = e.name
        return lambda cols: cols[name]
    if isinstance(e, Literal):
        v = e.value
        return lambda cols: v
    if isinstance(e, BinaryOp):
        lf, rf, op = compile_host_expr(e.left), compile_host_expr(e.right), _BINARY[e.op]
        return lambda cols: op(lf(cols), rf(cols))
    if isinstance(e, UnaryOp):
        f, op = compile_host_expr(e.operand), _UNARY_NP[e.op]
        return lambda cols: op(np.asarray(f(cols)))
    if isinstance(e, Comparison):
        return _compile_host_comparison(e)
    if isinstance(e, BoolOp):
        fs = [compile_host_expr(o) for o in e.operands]
        if e.op == "not":
            return lambda cols: np.logical_not(fs[0](cols))
        op = np.logical_and if e.op == "and" else np.logical_or

        def fold(cols):
            acc = fs[0](cols)
            for f in fs[1:]:
                acc = op(acc, f(cols))
            return acc

        return fold
    if isinstance(e, InExpr):
        f = compile_host_expr(e.operand)
        if any(isinstance(v, str) for v in e.values):
            vals = list(e.values)
            return lambda cols: np.isin(np.asarray(f(cols), dtype=object), vals)
        # NaN never matches; pandas isin hashes for every dtype
        values = [v for v in e.values if not (isinstance(v, float) and v != v)]

        def host_in(cols):
            import pandas as pd

            return pd.Series(np.asarray(f(cols))).isin(values).to_numpy()

        return host_in
    if isinstance(e, IfExpr):
        cf, tf, of = (compile_host_expr(x) for x in (e.cond, e.then, e.otherwise))

        def host_if(cols):
            c = np.asarray(cf(cols)).astype(bool)
            t, o, _ = np.broadcast_arrays(np.asarray(tf(cols)), np.asarray(of(cols)), c)
            return np.where(c, t, o)

        return host_if
    if isinstance(e, Cast):
        f = compile_host_expr(e.operand)
        dt = {"double": np.float32, "long": np.int32, "bool": np.bool_}[e.to]
        return lambda cols: np.asarray(f(cols)).astype(dt)
    if isinstance(e, TimeBucket):
        f, p = compile_host_expr(e.operand), e.period_ms
        if p is not None:
            return lambda cols: (np.asarray(f(cols)) // p * p).astype(np.int64)
        from ..utils.granularity import _iso_calendar_months

        k = _iso_calendar_months(e.granularity)

        def cal_trunc(cols):
            t = np.asarray(f(cols)).astype("datetime64[ms]")
            months = t.astype("datetime64[M]").astype(np.int64)
            b = ((months // k) * k).astype("datetime64[M]")
            return b.astype("datetime64[ms]").astype(np.int64)

        return cal_trunc
    if isinstance(e, TimeExtract):
        if e.field not in _EXTRACT_FIELDS:
            raise ValueError(
                f"EXTRACT field {e.field!r}; supported: {sorted(_EXTRACT_FIELDS)}"
            )
        f, field = compile_host_expr(e.operand), e.field
        return lambda cols: _time_extract(
            torch.from_numpy(np.asarray(f(cols), dtype=np.int64)), field
        ).numpy()
    if isinstance(e, LikeExpr):
        import re

        from ..ops.filters import _like_to_regex

        rx, f, neg = re.compile(_like_to_regex(e.pattern)), compile_host_expr(e.operand), e.negated

        def like_host(cols):
            vals = np.asarray(f(cols), dtype=object)
            m = np.array([v is not None and bool(rx.search(str(v))) for v in vals], bool)
            if not neg:
                return m
            # NULL NOT LIKE p is NULL -> excluded
            return np.array([v is not None for v in vals], bool) & ~m

        return like_host
    if isinstance(e, StrFunc) and e.fn != "lookup":
        f = compile_host_expr(e.operand)

        def str_host(cols, fn=e.fn, a=e.args):
            import pandas as pd

            def ap(v):
                if pd.isna(v):
                    return None
                return apply_strfunc(fn, a, v if isinstance(v, str) else str(v))

            return np.array([ap(v) for v in np.asarray(f(cols))], dtype=object)

        return str_host
    raise TypeError(f"cannot compile host expression {e!r}")


def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Literal:
    return Literal(v)
