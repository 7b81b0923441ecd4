"""Exact f32-column vs f64-literal comparison semantics.

SQL promotes a float32 column compared against a decimal literal to double;
an engine computing in f32 would silently flip rows whose f32 value
round-trips above/below the literal (e.g. f32(0.05) > 0.05 in f64, == in
f32).  Comparing correctly does NOT require f64 on device: for f32 x and f64
threshold c,

    x >  c  ⇔  x >= (smallest f32 strictly greater than c)
    x >= c  ⇔  x >= (smallest f32 >= c)
    x <  c  ⇔  x <= (largest  f32 strictly less  than c)
    x <= c  ⇔  x <= (largest  f32 <= c)
    x == c  ⇔  c exactly representable in f32 ∧ x == f32(c)

so each predicate compiles to a single f32 compare against a host-adjusted
threshold — exact double semantics at f32 speed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_INF32 = np.float32(np.inf)


def _up(c: float) -> np.float32:
    """Smallest f32 strictly greater than f64 c."""
    f = np.float32(c)
    return f if float(f) > c else np.nextafter(f, _INF32)


def _ceil(c: float) -> np.float32:
    f = np.float32(c)
    return f if float(f) >= c else np.nextafter(f, _INF32)


def _down(c: float) -> np.float32:
    f = np.float32(c)
    return f if float(f) < c else np.nextafter(f, -_INF32)


def _floor(c: float) -> np.float32:
    f = np.float32(c)
    return f if float(f) <= c else np.nextafter(f, -_INF32)


def f32_compare_threshold(op: str, c: float) -> Tuple[str, np.float32]:
    """(new_op, f32 threshold) such that `x new_op threshold` in f32 equals
    `x op c` in f64, for all f32 x."""
    if op == ">":
        return ">=", _up(c)
    if op == ">=":
        return ">=", _ceil(c)
    if op == "<":
        return "<=", _down(c)
    if op == "<=":
        return "<=", _floor(c)
    raise ValueError(op)


def f32_representable(c: float) -> bool:
    return float(np.float32(c)) == float(c)


def f32_adjusted_compare(op: str, c: float):
    """Precompiled comparison `x op c` with f64-exact semantics for f32 x.
    Returns fn(x_f32_array) -> bool array; all threshold math happens here,
    once, at compile time (shared by plan/expr.py and ops/filters.py)."""
    import torch

    if op in ("==", "!="):
        if not f32_representable(c):
            if op == "==":
                return lambda x: torch.zeros_like(x, dtype=torch.bool)
            return lambda x: torch.ones_like(x, dtype=torch.bool)
        # a python float compares against an f32 tensor in f32; cv is
        # exactly representable, so the compare is exact
        cv = float(np.float32(c))
        if op == "==":
            return lambda x: x == cv
        return lambda x: x != cv
    adj_op, thr = f32_compare_threshold(op, c)
    thr = float(thr)
    if adj_op == ">=":
        return lambda x: x >= thr
    return lambda x: x <= thr


# f32-vs-f64 accumulation tolerance for comparing a device result against a
# float64 host result (the fallback interpreter / a pandas oracle): the
# engine's partial sums accumulate in f32, so equal queries agree to ~1e-5
# relative.  Shared by the fault-injection differential suite and ad-hoc
# parity checks so "identical within tolerance" means ONE thing repo-wide.
F32_ACCUM_RTOL = 2e-5


def frames_allclose(a, b, rtol: float = F32_ACCUM_RTOL, atol: float = 1e-8):
    """Order-insensitive DataFrame equivalence under f32-accumulation
    tolerance: same columns, same rows after sorting by every column
    (string columns compared exactly, numeric within rtol/atol, NaN==NaN).
    Returns (ok, message)."""
    import numpy as np
    import pandas as pd

    if list(a.columns) != list(b.columns):
        return False, f"columns differ: {list(a.columns)} vs {list(b.columns)}"
    if len(a) != len(b):
        return False, f"row counts differ: {len(a)} vs {len(b)}"
    if not len(a):
        return True, ""

    def _norm(df):
        out = df.copy()
        for c in out.columns:
            v = out[c]
            if v.dtype.kind in "fc":
                # quantize floats so near-ties sort identically both sides
                out[c] = np.round(v.astype(np.float64), 4)
        return out

    order = list(a.columns)
    ai = _norm(a).sort_values(order, kind="stable").index
    bi = _norm(b).sort_values(order, kind="stable").index
    a = a.loc[ai].reset_index(drop=True)
    b = b.loc[bi].reset_index(drop=True)
    for c in a.columns:
        av, bv = np.asarray(a[c]), np.asarray(b[c])
        if av.dtype.kind in "fc" or bv.dtype.kind in "fc":
            av = av.astype(np.float64)
            bv = bv.astype(np.float64)
            both_nan = np.isnan(av) & np.isnan(bv)
            close = np.isclose(av, bv, rtol=rtol, atol=atol) | both_nan
            if not close.all():
                i = int(np.argmin(close))
                return False, (
                    f"column {c!r} row {i}: {av[i]!r} != {bv[i]!r} "
                    f"(rtol={rtol})"
                )
        else:
            sa, sb = pd.Series(av), pd.Series(bv)
            na_a, na_b = np.asarray(sa.isna()), np.asarray(sb.isna())
            eq = (np.asarray(sa.eq(sb)) & ~na_a & ~na_b) | (na_a & na_b)
            if not eq.all():
                i = int(np.argmin(eq))
                return False, f"column {c!r} row {i}: {av[i]!r} != {bv[i]!r}"
    return True, ""
