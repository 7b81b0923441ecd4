"""Filter selectivity estimate: the one piece of the cost model the port
reads so far.

The sparse tier (`exec/sparse_exec.py`) picks its first row-capacity rung
from `estimate_selectivity`.  The rest of the reference's cost model (kernel
classes, mesh choice, calibrated constants) ports with a CUDA calibration;
until then the engine resolves its strategies itself
(`ops/groupby.resolve_strategy` and the tiers of `exec/engine.Engine`).
"""

from __future__ import annotations

import numpy as np

from ..catalog.segment import DataSource
from ..models import filters as F
from ..ops.filters import numeric_dict_code_bounds


def estimate_selectivity(filt, ds: DataSource) -> float:
    """Estimated surviving-row fraction of a filter spec, from the
    dictionaries under a uniformity assumption: conjuncts multiply,
    disjuncts add (capped at 1), a numeric Bound admits its share of the
    sorted code space.  Anything unmodeled estimates 1.0."""
    if filt is None:
        return 1.0
    if isinstance(filt, F.And):
        s = 1.0
        for x in filt.fields:
            s *= estimate_selectivity(x, ds)
        return s
    if isinstance(filt, F.Or):
        return min(1.0, sum(estimate_selectivity(x, ds) for x in filt.fields))
    if isinstance(filt, F.Not):
        return max(0.0, 1.0 - estimate_selectivity(filt.field, ds))
    if isinstance(filt, F.Selector):
        d = ds.dicts.get(filt.dimension)
        if d is None or not d.cardinality:
            return 1.0
        if filt.value is not None and d.code_of(filt.value) is None:
            return 0.0
        return 1.0 / d.cardinality
    if isinstance(filt, F.InFilter):
        d = ds.dicts.get(filt.dimension)
        if d is None or not d.cardinality:
            return 1.0
        hits = sum(1 for v in filt.values if d.code_of(v) is not None)
        return min(1.0, hits / d.cardinality)
    if isinstance(filt, F.Bound):
        d = ds.dicts.get(filt.dimension)
        if d is not None and d.cardinality:
            nv = d.numeric_values
            if nv is not None and filt.ordering != "lexicographic":
                cb = numeric_dict_code_bounds(filt, np.asarray(nv))
                if cb is None:
                    return 1.0
                lo, hi = cb
                lo = 0 if lo is None else max(0, lo)
                hi = d.cardinality - 1 if hi is None else min(d.cardinality - 1, hi)
                return max(0.0, (hi - lo + 1) / d.cardinality)
        return 1.0 / 3.0  # the textbook guess for an unmodeled range
    return 1.0
