"""Compile Filter spec trees into boolean row-mask functions over tensors.

A planner-produced spec tree compiles into `fn(cols) -> bool[R]` over
device-resident columns; a filter costs a few element-wise passes over the
columns it reads.

Dictionary tricks (all host-side, per-query, O(dictionary) not O(rows)):
* Selector / In   -> int equality / isin on codes.
* Bound on string -> because dictionaries are sorted (catalog/segment.py),
  lexicographic bounds become integer range tests on codes.
* Regex / Like    -> run the regex over dictionary values once; the matching
  code set becomes an isin.

Code-space tests read codes widened to int32 (`plan.expr.codes`): stored
codes are int8/int16, and torch compares a narrow tensor with an
out-of-range Python int after wrapping it.
"""

from __future__ import annotations

import re
from typing import Callable, Mapping

import numpy as np
import torch

from ..catalog.segment import DataSource
from ..models import filters as F
from ..plan.expr import (
    DeviceConst,
    coerce_str_literal,
    codes,
    compile_expr,
    isin,
)


def _bound_literal(v) -> float | None:
    """Numeric value of a Bound literal: numbers pass through; ISO
    date/timestamp strings become epoch ms."""
    if v is None:
        return None
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return coerce_str_literal(str(v))


def numeric_dict_code_bounds(f, nv: np.ndarray):
    """Code-space [lo, hi] (either side possibly None) for a numeric Bound
    over a SORTED numeric dictionary, or None when numeric ordering cannot
    apply (explicit lexicographic, or a non-numeric literal).  Shared by
    the kernel compile (`bound_numdict`) and zone-map segment pruning
    (exec/engine.py) — one translation, so the two can never drift."""
    if f.ordering == "lexicographic":
        return None
    lo_f = _bound_literal(f.lower)
    hi_f = _bound_literal(f.upper)
    if (f.lower is not None and lo_f is None) or (
        f.upper is not None and hi_f is None
    ):
        return None
    lo_code = hi_code = None
    if lo_f is not None:
        side = "right" if f.lower_strict else "left"
        lo_code = int(np.searchsorted(nv, lo_f, side=side))
    if hi_f is not None:
        side = "left" if f.upper_strict else "right"
        hi_code = int(np.searchsorted(nv, hi_f, side=side)) - 1
    return lo_code, hi_code


MaskFn = Callable[[Mapping[str, torch.Tensor]], torch.Tensor]


class DecodedView:
    """Column mapping for *expression* evaluation: numeric-dictionary
    dimension codes decode back to their integer values (a device gather);
    all other columns pass through.  Filters, by contrast, are translated
    into code space at compile time and read the raw mapping — the two views
    share the same underlying device tensors."""

    def __init__(self, cols: Mapping, dicts: Mapping):
        self._cols = cols
        self._dicts = dicts

    def __getitem__(self, name):
        c = self._cols[name]
        d = self._dicts[name] if name in self._dicts else None
        if d is not None and d.numeric_values is not None:
            nv = _numeric_values(d).on(c.device)
            # null codes (-1) decode to -1, matching the raw-value
            # convention; the values are int64 (times may exceed int32)
            return torch.where(
                c >= 0, nv[torch.clamp(c.long(), min=0)], torch.tensor(
                    -1, dtype=torch.int64, device=c.device
                )
            )
        return c

    def __contains__(self, name):
        return name in self._cols

    def raw(self, name):
        """Undecoded column (dictionary codes for dims) — null guards in
        compiled expressions read this to exclude -1 codes exactly."""
        return self._cols[name]

    def get(self, name, default=None):
        return self[name] if name in self._cols else default


def _numeric_values(d) -> DeviceConst:
    """The int64 value table of a numeric dictionary, kept on each device
    once (dictionaries are immutable)."""
    const = d.__dict__.get("_device_values")
    if const is None:
        const = DeviceConst(np.asarray(d.numeric_values, dtype=np.int64))
        object.__setattr__(d, "_device_values", const)
    return const


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


def like_match_codes(d, pattern: str, is_regex: bool = False) -> np.ndarray:
    """int32 codes of the dictionary values matching a LIKE (or anchored
    regex) pattern — the one dictionary->code-set translation shared by the
    filter layer and expression compilation (plan/expr.py)."""
    rx = re.compile(pattern if is_regex else _like_to_regex(pattern))
    return np.array(
        [i for i, v in enumerate(d.values) if rx.search(str(v))],
        dtype=np.int32,
    )


def _false(c: torch.Tensor) -> torch.Tensor:
    return torch.zeros(c.shape, dtype=torch.bool, device=c.device)


def compile_filter(f: F.Filter, ds: DataSource) -> MaskFn:
    """Returns fn(cols) -> bool[R]: the KLEENE TRUE mask — rows where the
    predicate is definitely true.  `cols` maps column name -> device tensor
    (dimension codes, metric values, and "__time").

    Three-valued semantics: leaves report a per-row UNKNOWN mask (null
    dimension codes / NaN metrics), combinators apply Kleene algebra, and
    only definitely-TRUE rows survive (SQL: NOT UNKNOWN is UNKNOWN)."""
    fn3 = compile_filter3(f, ds)
    return lambda cols: fn3(cols)[0]


def compile_filter3(f: F.Filter, ds: DataSource):
    """fn(cols) -> (true_mask, unknown_mask) under Kleene algebra."""
    if isinstance(f, F.And):
        fns = [compile_filter3(x, ds) for x in f.fields]

        def and3(cols, fns=fns):
            pairs = [fn(cols) for fn in fns]
            t = _fold_pairs(torch.logical_and, [p[0] for p in pairs])
            fmask = _fold_pairs(
                torch.logical_or, [~p[0] & ~p[1] for p in pairs]
            )
            return t, ~t & ~fmask

        return and3
    if isinstance(f, F.Or):
        fns = [compile_filter3(x, ds) for x in f.fields]

        def or3(cols, fns=fns):
            pairs = [fn(cols) for fn in fns]
            t = _fold_pairs(torch.logical_or, [p[0] for p in pairs])
            fmask = _fold_pairs(
                torch.logical_and, [~p[0] & ~p[1] for p in pairs]
            )
            return t, ~t & ~fmask

        return or3
    if isinstance(f, F.Not):
        fn = compile_filter3(f.field, ds)

        def not3(cols, fn=fn):
            t, u = fn(cols)
            return ~t & ~u, u

        return not3
    t_fn = _leaf_true(f, ds)
    u_fn = _leaf_unknown(f, ds)
    return lambda cols: (t_fn(cols), u_fn(cols))


def _null_mask_fn(dim: str, ds: DataSource):
    """Per-row SQL-NULL mask of a column: dictionary dims use the -1 null
    code; float metrics use NaN; everything else (time, int metrics) has
    no null representation."""
    if dim in ds.dicts:
        return lambda cols: cols[dim] == -1

    def nf(cols, dim=dim):
        c = cols[dim]
        if c.dtype.is_floating_point:
            return torch.isnan(c)
        return _false(c)

    return nf


def _leaf_unknown(f: F.Filter, ds: DataSource):
    """UNKNOWN mask of a leaf predicate: its operand column is NULL —
    except IS NULL itself (two-valued) and time-interval filters (time is
    never null).  ExpressionFilter stays 2-valued (its expression compile
    owns null coalescing)."""
    if isinstance(f, F.Selector) and f.value is None:
        return lambda cols: _false(cols[f.dimension])
    if isinstance(f, F.InFilter) and f.null_in_values:
        # the original list held a literal NULL: `x IN (..., NULL)` is
        # UNKNOWN for every non-member (x = NULL might have matched), so
        # the unknown mask is the complement of the definite-member mask
        t_fn = _leaf_true(f, ds)
        return lambda cols: ~t_fn(cols)
    if isinstance(
        f, (F.Selector, F.InFilter, F.Bound, F.Regex, F.LikeFilter)
    ):
        return _null_mask_fn(f.dimension, ds)

    def fconst(cols):
        return _false(next(iter(cols.values())))

    return fconst


def _code_set(dim: str, cs: np.ndarray) -> MaskFn:
    if len(cs) == 0:
        return lambda cols: _false(cols[dim])
    const = DeviceConst(np.asarray(cs, dtype=np.int32))
    return lambda cols: isin(codes(cols, dim), const)


def _code_range(dim: str, lo, hi) -> MaskFn:
    def bound_codes(cols, lo=lo, hi=hi, dim=dim):
        c = codes(cols, dim)
        m = c >= 0
        if lo is not None:
            m = m & (c >= lo)
        if hi is not None:
            m = m & (c <= hi)
        return m

    return bound_codes


def _leaf_true(f: F.Filter, ds: DataSource) -> MaskFn:
    """The definitely-TRUE mask of a LEAF predicate (nulls never match any
    of these by construction: code-space tests exclude -1, NaN compares
    false)."""

    if isinstance(f, F.Selector):
        dim = f.dimension
        if dim in ds.dicts:
            d = ds.dicts[dim]
            if f.value is None:
                return lambda cols: cols[dim] == -1
            code = d.code_of(f.value)
            if code is None:
                return lambda cols: _false(cols[dim])
            return lambda cols: codes(cols, dim) == code
        if f.value is None:
            # IS NULL on a non-dictionary column — same null
            # representation the unknown masks use
            return _null_mask_fn(dim, ds)
        # numeric column equality
        v = float(f.value)  # type: ignore[arg-type]
        return lambda cols: cols[dim] == v

    if isinstance(f, F.InFilter):
        dim = f.dimension
        if dim in ds.dicts:
            d = ds.dicts[dim]
            return _code_set(dim, np.array(
                [c for c in (d.code_of(v) for v in f.values) if c is not None],
                dtype=np.int32,
            ))
        vals = np.asarray([float(v) for v in f.values])
        if len(vals) == 0:
            return lambda cols: _false(cols[dim])
        const = DeviceConst(vals)
        return lambda cols: torch.isin(
            cols[dim].to(torch.float64), const.on(cols[dim].device)
        )

    if isinstance(f, F.Bound):
        dim = f.dimension
        nv = ds.dicts[dim].numeric_values if dim in ds.dicts else None
        if nv is not None:
            # numeric dictionary: value bounds -> dense-code bounds (sound:
            # codes are the numeric rank, so value order == code order).
            # Honors an explicit lexicographic ordering, and falls back to
            # lexicographic when a bound literal isn't numeric.
            cb = numeric_dict_code_bounds(f, np.asarray(nv))
            if cb is not None:
                return _code_range(dim, *cb)
            # lexicographic semantics over a numerically-sorted domain: the
            # two orders differ, so compare stringified values per code and
            # push the matching code set (O(dictionary), like Regex)
            vals = np.asarray([str(v) for v in ds.dicts[dim].values], dtype=str)
            ok = np.ones(len(vals), dtype=bool)
            # Druid coerces bound literals to strings on the wire — accept
            # numeric literals under lexicographic ordering the same way
            if f.lower is not None:
                lo_s = str(f.lower)
                ok &= (vals > lo_s) if f.lower_strict else (vals >= lo_s)
            if f.upper is not None:
                hi_s = str(f.upper)
                ok &= (vals < hi_s) if f.upper_strict else (vals <= hi_s)
            return _code_set(dim, np.nonzero(ok)[0].astype(np.int32))
        if dim in ds.dicts and f.ordering == "lexicographic":
            vals = np.asarray(ds.dicts[dim].values, dtype=str)
            lo_code = hi_code = None
            if f.lower is not None:
                side = "right" if f.lower_strict else "left"
                lo_code = int(np.searchsorted(vals, f.lower, side=side))
            if f.upper is not None:
                side = "left" if f.upper_strict else "right"
                hi_code = int(np.searchsorted(vals, f.upper, side=side)) - 1
            return _code_range(dim, lo_code, hi_code)

        from ..utils.floatcmp import f32_adjusted_compare

        lo = _bound_literal(f.lower)
        hi = _bound_literal(f.upper)
        if (f.lower is not None and lo is None) or (
            f.upper is not None and hi is None
        ):
            raise ValueError(
                f"Bound on numeric column {dim!r} has a non-numeric, non-date "
                f"literal: lower={f.lower!r} upper={f.upper!r}"
            )
        # f32-exact comparators precompiled once (shared helper with expr.py);
        # other dtypes (int64 time, int32 metrics) compare in float64, the
        # reference's semantics for a float literal
        lo_op = ">" if f.lower_strict else ">="
        hi_op = "<" if f.upper_strict else "<="
        lo32 = f32_adjusted_compare(lo_op, lo) if lo is not None else None
        hi32 = f32_adjusted_compare(hi_op, hi) if hi is not None else None

        def bound_num(cols, lo=lo, hi=hi, f=f, dim=dim):
            c = cols[dim]
            is_f32 = c.dtype == torch.float32
            if not is_f32:
                c = c.to(torch.float64)
            m = None
            if lo is not None:
                m = lo32(c) if is_f32 else (
                    (c > lo) if f.lower_strict else (c >= lo)
                )
            if hi is not None:
                mh = hi32(c) if is_f32 else (
                    (c < hi) if f.upper_strict else (c <= hi)
                )
                m = mh if m is None else m & mh
            return torch.ones_like(c, dtype=torch.bool) if m is None else m

        return bound_num

    if isinstance(f, (F.Regex, F.LikeFilter)):
        dim = f.dimension
        return _code_set(dim, like_match_codes(
            ds.dicts[dim], f.pattern, is_regex=isinstance(f, F.Regex)
        ))

    if isinstance(f, F.IntervalFilter):
        dim = f.dimension
        ivs = f.intervals

        def interval(cols, ivs=ivs, dim=dim):
            t = cols[dim]
            m = _false(t)
            for a, b in ivs:
                m = m | ((t >= a) & (t < b))
            return m

        return interval

    if isinstance(f, F.ExpressionFilter):
        fn = compile_expr(f.expression, ds.dicts)
        dicts = ds.dicts
        return lambda cols: fn(DecodedView(cols, dicts)).to(torch.bool)

    raise TypeError(f"cannot compile filter {f!r}")


def _fold_pairs(op, masks):
    acc = masks[0]
    for m in masks[1:]:
        acc = op(acc, m)
    return acc
