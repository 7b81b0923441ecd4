"""Single-device query engine: QuerySpec x DataSource -> pandas DataFrame.

`Engine.execute` runs a Druid-native query spec (GroupBy, Timeseries, TopN)
over a datasource's segments:

1. `segments_in_scope` prunes segments by the query interval and by
   per-segment zone maps;
2. each in-scope segment's needed columns move to the device once and stay
   resident under a byte budget (the analog of Druid's segment residency);
3. per segment, `GroupByLowering.row_arrays` builds the filter mask, the
   combined group id and the pre-masked value columns, and
   `ops/groupby.partial_aggregate` reduces them to [G, M] partial states —
   on a CUDA device through the hand-written kernel (`ops/cuda_groupby.py`)
   for G <= SCATTER_CUTOVER; from the same group ids and mask,
   `sketch_partials` builds each sketch aggregator's partial state (HLL
   registers, theta hash sets, quantile samples: `ops/hll.py`,
   `ops/theta.py`, `ops/quantiles.py`);
4. the partials fold in canonical segment order (sums add, min/max take
   `torch.minimum`/`torch.maximum`, sketches merge by type), so a query's
   float sums and sketch states are bit-identical from run to run;
5. only the merged state comes back to the host, in one fetch, where
   `exec/finalize.py` decodes groups, finalizes sketches, evaluates
   post-aggregations, having and limit, and builds the DataFrame.

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
device given and no GPU present, `Engine()` raises.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..catalog.segment import DataSource, Segment
from ..models import filters as F
from ..models import query as Q
from ..ops.filters import numeric_dict_code_bounds
from ..ops.groupby import partial_aggregate, resolve_strategy
from ..utils.lru import ByteBudgetCache, CountBudgetCache
from .finalize import finalize_groupby, finalize_timeseries, finalize_topn
from .lowering import (
    GroupByLowering,
    LoweredAggs,
    _query_key,
    empty_partials,
    groupby_with_time_granularity,
    lower_groupby,
    sketch_ops,
    timeseries_to_groupby,
    topn_to_groupby,
)
from .metrics import QueryMetrics


def _bytes_scanned(segs, columns) -> int:
    """Bytes of segment data a query reads: needed columns plus the validity
    mask over real rows."""
    total = 0
    for s in segs:
        row_bytes = 1  # valid mask
        for n in columns:
            try:
                row_bytes += s.column(n).dtype.itemsize
            except KeyError:
                pass  # virtual columns are computed, not read
        total += row_bytes * s.num_rows
    return total


def _prune_by_stats(segs, filt, ds: DataSource, vcol_names=frozenset()):
    """Zone-map pruning on a CONSERVATIVE filter subset: top-level AND
    conjuncts that are Selector/In over dictionary columns (matched in code
    space — dictionaries are datasource-global, so codes compare across
    segments) or numeric Bounds.  Everything else is left to the row
    mask — pruning may only ever REMOVE provably-empty segments.

    `vcol_names`: virtual-column names defined by the query.  A filter on a
    virtual column that SHADOWS a physical column evaluates against the
    virtual values, so pruning it against the physical column's stats would
    drop live segments — skip those."""

    def _conjuncts(f):
        # the planner builds Ands pairwise (And(And(a, b), c)): flatten
        # recursively or buried conjuncts never get a pruning look
        if isinstance(f, F.And):
            out = []
            for x in f.fields:
                out.extend(_conjuncts(x))
            return out
        return [f]

    conjuncts = _conjuncts(filt)

    def excluded(seg, c) -> bool:
        if getattr(c, "dimension", None) in vcol_names:
            return False
        if isinstance(c, F.Or):
            # a disjunction can only match if SOME disjunct can
            return bool(c.fields) and all(excluded(seg, x) for x in c.fields)
        if isinstance(c, F.And):
            return any(excluded(seg, x) for x in c.fields)
        st = seg.stats or {}
        if isinstance(c, F.Selector):
            if c.value is None or c.dimension not in ds.dicts:
                return False  # null stats aren't tracked
            code = ds.dicts[c.dimension].code_of(c.value)
            if code is None:
                return True  # value absent from the whole datasource
            b = st.get(c.dimension)
            return b is not None and not (b[0] <= code <= b[1])
        if isinstance(c, F.InFilter):
            if c.dimension not in ds.dicts:
                return False
            if any(v is None for v in c.values):
                return False  # null membership isn't in the stats
            codes = [
                x
                for x in (ds.dicts[c.dimension].code_of(v) for v in c.values)
                if x is not None
            ]
            if not codes:
                return True  # none of the values exist in the datasource
            b = st.get(c.dimension)
            return b is not None and not any(b[0] <= x <= b[1] for x in codes)
        if isinstance(c, F.Bound) and c.ordering == "numeric":
            b = st.get(c.dimension)
            if b is None:
                return False
            if c.dimension in ds.dicts:
                # numeric dictionary: translate to code space with the SAME
                # helper the row-mask compile uses, then compare against the
                # code-space zone map
                nv = ds.dicts[c.dimension].numeric_values
                if nv is None:
                    return False
                cb = numeric_dict_code_bounds(c, np.asarray(nv))
                if cb is None:
                    return False
                lo_code, hi_code = cb
                if lo_code is not None and b[1] < lo_code:
                    return True
                if hi_code is not None and b[0] > hi_code:
                    return True
                return False
            try:
                if c.lower is not None:
                    lo = float(c.lower)
                    if b[1] < lo or (c.lower_strict and b[1] <= lo):
                        return True
                if c.upper is not None:
                    hi = float(c.upper)
                    if b[0] > hi or (c.upper_strict and b[0] >= hi):
                        return True
            except ValueError:
                return False
            return False
        return False

    return [s for s in segs if not any(excluded(s, c) for c in conjuncts)]


def segments_in_scope(q, ds: DataSource) -> List[Segment]:
    """Segment pruning by time interval and by per-segment zone maps, in
    canonical (datasource) order."""
    segs = list(ds.segments)
    if q.intervals:
        segs = [
            s for s in segs
            if s.interval is None
            or any(a <= s.interval[1] and s.interval[0] < b for a, b in q.intervals)
        ]
    filt = getattr(q, "filter", None)
    if filt is not None and segs:
        vcols = frozenset(
            v.name for v in getattr(q, "virtual_columns", ()) or ()
        )
        segs = _prune_by_stats(segs, filt, ds, vcols)
    return segs


def sketch_partials(
    lowering: GroupByLowering, cols, gid: torch.Tensor, mask: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """One segment's sketch partial states, from the group ids and row mask
    its sums use.  A sketch's FILTER clause narrows the mask as it does for
    sum/min/max columns.  `cols` must hold the virtual columns
    (`lowering.add_virtual`)."""
    la, G = lowering.la, lowering.num_groups
    sk = {}
    for agg in la.sketch_aggs:
        mfn = la.mask_fns.get(agg.name)
        amask = mask & mfn(cols) if mfn is not None else mask
        sk[agg.name] = sketch_ops(agg).partial(agg, cols, gid, amask, G)
    return sk


def merge_sketch_states(
    la: LoweredAggs, acc: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
) -> None:
    """Fold one segment's sketch partials into the accumulator in place,
    the accumulator first (HLL registers max-merge; theta and quantile
    states union, keeping the bottom K)."""
    for agg in la.sketch_aggs:
        prev = acc.get(agg.name)
        st = new[agg.name]
        acc[agg.name] = st if prev is None else sketch_ops(agg).merge_states(prev, st, agg)


def sketch_states_to_reference(
    la: LoweredAggs, states: Dict[str, torch.Tensor]
) -> Dict[str, np.ndarray]:
    """Fetch merged sketch states to the host in the reference's layout."""
    return {
        agg.name: sketch_ops(agg).to_reference_state(states[agg.name])
        for agg in la.sketch_aggs
    }


LOWERING_CACHE_ENTRIES = 256


def _default_device_budget(device: torch.device) -> int:
    """Residency byte budget: 3/4 of the card's memory, leaving the rest for
    kernel workspace and partial states; on the CPU, where "device" columns
    are host memory shared with the segments, half the machine."""
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total) * 3 // 4
    return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")) // 2


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another.  With no
    device given and no GPU present this raises rather than running on the
    host unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the host"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Engine:
    """Executes GroupBy, Timeseries and TopN query specs on one device.

    The group-by strategy follows `ops/groupby.resolve_strategy`: scatter
    above SCATTER_CUTOVER groups; at or below it the CUDA kernel on a CUDA
    device and the plain dense version on the CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # LRU residency of device columns under a byte budget
        self._device_cache = ByteBudgetCache(_default_device_budget(self.device))
        # (query json, datasource schema) -> GroupByLowering: lowering is
        # host work that also stages device constants
        self._lowering_cache = CountBudgetCache(LOWERING_CACHE_ENTRIES)
        self.last_metrics: Optional[QueryMetrics] = None

    # -- segment residency ---------------------------------------------------

    def _device_col(self, key, host_fn, m: QueryMetrics) -> torch.Tensor:
        t = self._device_cache.get(key)
        if t is None:
            host = host_fn()
            t0 = time.perf_counter()
            t = torch.from_numpy(np.ascontiguousarray(host)).to(self.device)
            m.h2d_ms += (time.perf_counter() - t0) * 1e3
            m.h2d_bytes += int(host.nbytes)
            self._device_cache[key] = t
        return t

    def _cols_for_segment(
        self, seg: Segment, ds: DataSource, names, m: QueryMetrics
    ) -> Dict[str, torch.Tensor]:
        # "col"/"valid" key tags: a user column literally named "__valid"
        # must not alias the validity-mask entry
        cols = {
            n: self._device_col((seg.uid, "col", n), lambda n=n: seg.column(n), m)
            for n in names
        }
        cols["__valid"] = self._device_col((seg.uid, "valid"), lambda: seg.valid, m)
        if ds.time_column and ds.time_column in cols:
            cols["__time"] = cols[ds.time_column]
        return cols

    def bytes_resident(self) -> int:
        """Device bytes held by the segment residency cache."""
        return self._device_cache.bytes_used

    def clear_cache(self):
        """Drop the resident columns and the cached lowerings (which close
        over staged device constants)."""
        self._device_cache.clear()
        self._lowering_cache.clear()

    # -- entry points --------------------------------------------------------

    def execute(self, q: Q.QuerySpec, ds: DataSource):
        if isinstance(q, Q.GroupByQuery):
            return self._execute_groupby(q, ds)
        if isinstance(q, Q.TimeseriesQuery):
            df = self._execute_groupby(timeseries_to_groupby(q), ds)
            return finalize_timeseries(df, q, ds)
        if isinstance(q, Q.TopNQuery):
            df = self._execute_groupby(topn_to_groupby(q), ds)
            return finalize_topn(df, q)
        raise NotImplementedError(type(q).__name__)

    # -- groupby -------------------------------------------------------------

    def _lowering_for(self, q: Q.GroupByQuery, ds: DataSource) -> GroupByLowering:
        key = _query_key(q, ds)
        lowering = self._lowering_cache.get(key)
        if lowering is None:
            lowering = lower_groupby(q, ds)
            self._lowering_cache[key] = lowering
        return lowering

    def _execute_groupby(self, q: Q.GroupByQuery, ds: DataSource):
        t_total = time.perf_counter()
        q = groupby_with_time_granularity(q)
        lowering = self._lowering_for(q, ds)
        segs = segments_in_scope(q, ds)
        la, G = lowering.la, lowering.num_groups
        strategy = resolve_strategy("auto", G, self.device)
        m = QueryMetrics(
            query_type="groupBy",
            strategy=strategy,
            datasource=ds.name,
            device=str(self.device),
            rows_scanned=sum(s.num_rows for s in segs),
            bytes_scanned=_bytes_scanned(segs, lowering.columns),
            segments=len(segs),
            num_groups=G,
        )
        t_dev = time.perf_counter()
        sums = mins = maxs = None
        sketches: Dict[str, torch.Tensor] = {}
        for seg in segs:  # canonical segment order: the fold order
            cols = self._cols_for_segment(seg, ds, lowering.columns, m)
            if la.sketch_aggs:
                cols = lowering.add_virtual(dict(cols))  # sketches read virtuals
            gid, mask, sv, mmv, mmm = lowering.row_arrays(cols)
            s, mn, mx = partial_aggregate(
                gid, mask, sv, mmv, mmm,
                num_groups=G,
                num_min=len(la.min_names),
                num_max=len(la.max_names),
                strategy=strategy,
            )
            sums = s if sums is None else sums + s
            mins = mn if mins is None else torch.minimum(mins, mn)
            maxs = mx if maxs is None else torch.maximum(maxs, mx)
            if la.sketch_aggs:
                merge_sketch_states(
                    la, sketches, sketch_partials(lowering, cols, gid, mask)
                )
        if sums is None:
            # every segment pruned: a valid, complete zero-row answer
            sums, mins, maxs, sketches = empty_partials(la, G, self.device)
        # the one host fetch of the query (synchronises the device)
        sums, mins, maxs = (t.cpu().numpy() for t in (sums, mins, maxs))
        sketches = sketch_states_to_reference(la, sketches)
        m.device_ms = (time.perf_counter() - t_dev) * 1e3 - m.h2d_ms
        t0 = time.perf_counter()
        out = finalize_groupby(q, lowering.dims, la, sums, mins, maxs, sketches)
        m.finalize_ms = (time.perf_counter() - t0) * 1e3
        m.total_ms = (time.perf_counter() - t_total) * 1e3
        m.bytes_resident = self.bytes_resident()
        self.last_metrics = m
        return out
