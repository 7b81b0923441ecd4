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


def _collect_cols(e: Expr, out: list):
    if isinstance(e, Col):
        out.append(e.name)
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
    device copy is made once per device and kept."""

    def __init__(self, host: np.ndarray):
        self.host = np.ascontiguousarray(host)
        self._on = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = torch.from_numpy(self.host).to(device)
            self._on[device] = t
        return t


def as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A compiled sub-expression may yield a Python scalar (a literal);
    lift it to a tensor on `like`'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=None if like is None else like.device)


def isin(x: torch.Tensor, values: DeviceConst) -> torch.Tensor:
    return torch.isin(x, values.on(x.device))


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
    v = values.on(x.device)
    if x.dtype.is_floating_point or v.dtype.is_floating_point:
        return torch.isin(x.to(torch.float64), v.to(torch.float64))
    return torch.isin(x, v)


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


def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Literal:
    return Literal(v)
