"""Query lowering: dimensions, aggregations, and the row-kernel ABI.

Everything that turns a QuerySpec x DataSource into device-executable
pieces for `exec/engine.py`:

* dimension resolution (dictionary remaps, time bucketing, extractions),
* aggregation lowering into the kernel ABI merge classes,
* `GroupByLowering` (columns, row_arrays, filter mask),
* query-shape rewrites (Timeseries/TopN -> GroupBy, implicit granularity),
* lowering-cache identity (`_query_key`, `schema_signature`).

The lowered pieces are closures over torch tensors; they run eagerly on the
device the segment columns live on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..catalog.segment import DataSource
from ..models import aggregations as A
from ..models import query as Q
from ..models.dimensions import DimensionSpec
from ..models.filters import Filter
from ..ops import hll, quantiles, theta
from ..ops.filters import DecodedView, compile_filter
from ..ops.groupby import combine_group_ids
from ..plan.expr import DeviceConst, as_tensor, compile_expr
from ..utils.granularity import bucket_starts

# ---------------------------------------------------------------------------
# Dimension resolution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResolvedDim:
    """A dimension lowered to: device code producer + cardinality + decoder."""

    spec: DimensionSpec
    cardinality: int  # including the null slot when present
    codes_fn: Callable[[Mapping[str, torch.Tensor]], torch.Tensor]
    decode: Callable[[np.ndarray], np.ndarray]  # codes -> python values


def _resolve_dims(
    dims: Sequence[DimensionSpec],
    ds: DataSource,
    intervals: Tuple[Tuple[int, int], ...],
) -> List[ResolvedDim]:
    out: List[ResolvedDim] = []
    for spec in dims:
        if spec.dimension == "__time" or spec.granularity is not None:
            out.append(_resolve_time_dim(spec, ds, intervals))
            continue
        d = ds.dicts[spec.dimension]
        if spec.extraction is not None:
            # Host-side dictionary rewrite: apply fn to each dict value once,
            # build remap table code -> new code.
            # Extraction fns are string fns; numeric dictionaries stringify.
            extracted = spec.extraction.apply_to_dict(
                [v if isinstance(v, str) else str(v) for v in d.values]
            )
            # extraction fns may emit None (lookup with no retain/replace):
            # those values fold into the null slot
            new_vals = sorted({v for v in extracted if v is not None})
            index = {v: i for i, v in enumerate(new_vals)}
            card = len(new_vals) + 1  # + null slot
            remap = np.array(
                [
                    index[v] if v is not None else card - 1
                    for v in extracted
                ],
                dtype=np.int32,
            )
            remap_dev = DeviceConst(remap)
            name = spec.dimension

            def codes_fn(cols, remap_dev=remap_dev, name=name, card=card):
                c = cols[name].to(torch.int32)
                remap_t = remap_dev.on(c.device)
                return torch.where(
                    c >= 0, remap_t[torch.clamp(c, min=0).long()],
                    torch.full_like(c, card - 1),
                )

            vals_arr = np.asarray(new_vals, dtype=object)

            def decode(codes, vals_arr=vals_arr, card=card):
                o = np.empty(len(codes), dtype=object)
                isnull = codes == card - 1
                o[~isnull] = vals_arr[codes[~isnull]]
                o[isnull] = None
                return o

            out.append(ResolvedDim(spec, card, codes_fn, decode))
        else:
            card = d.cardinality + 1  # last slot = null
            name = spec.dimension

            def codes_fn(cols, name=name, card=card):
                # widened first: the null slot card - 1 may not fit the
                # stored code width
                c = cols[name].to(torch.int32)
                return torch.where(c >= 0, c, torch.full_like(c, card - 1))

            vals_arr = np.asarray(d.values, dtype=object)

            def decode(codes, vals_arr=vals_arr, card=card):
                o = np.empty(len(codes), dtype=object)
                isnull = codes == card - 1
                o[~isnull] = vals_arr[codes[~isnull]]
                o[isnull] = None
                return o

            out.append(ResolvedDim(spec, card, codes_fn, decode))
    return out


def _resolve_time_dim(
    spec: DimensionSpec, ds: DataSource, intervals
) -> ResolvedDim:
    gran = spec.granularity or "all"
    iv = intervals[0] if intervals else ds.interval()
    if iv is None:
        raise ValueError("time-bucketed dimension requires a time column")
    lo, hi = iv
    if intervals:
        lo = min(a for a, _ in intervals)
        hi = max(b for _, b in intervals)
        # open-ended predicate intervals (t >= x -> hi = 2^62) would expand
        # the bucket table unboundedly; the data's own range bounds it
        dsiv = ds.interval()
        if dsiv is not None:
            lo = max(lo, dsiv[0])
            hi = max(lo, min(hi, dsiv[1]))
    starts = bucket_starts(lo, hi, gran)  # host-computed bucket boundaries
    card = len(starts)
    starts_dev = DeviceConst(np.asarray(starts, dtype=np.int64))

    from ..utils.granularity import granularity_period_ms

    period = granularity_period_ms(gran) if gran.lower() != "all" else None

    def bucket_idx(t, first=int(starts[0]), period=period,
                   starts_dev=starts_dev, card=card):
        if period is not None:
            # FIXED-period granularity (minute/hour/day/week): plain int64
            # arithmetic instead of a searchsorted.  Out-of-range rows clip
            # into the edge buckets; the interval row-mask excludes them.
            return torch.clamp((t - first) // period, 0, card - 1).to(
                torch.int32
            )
        # calendar granularities (month/quarter/year): boundaries are
        # irregular — searchsorted over the host-computed starts
        return (
            torch.searchsorted(starts_dev.on(t.device), t, right=True).to(
                torch.int32
            )
            - 1
        )

    if spec.extraction is not None:
        # EXTRACT-style dims: many buckets fold to one extracted value
        # (e.g. MONTH over 3 years: 36 buckets -> 12 groups).  Host-side
        # remap over bucket starts; the kernel adds one tiny gather.
        extracted = spec.extraction.apply_to_dict([int(s) for s in starts])
        new_vals = sorted(set(extracted))
        index = {v: i for i, v in enumerate(new_vals)}
        remap_dev = DeviceConst(
            np.array([index[v] for v in extracted], dtype=np.int32)
        )
        n_remap = len(extracted)

        def codes_fn(cols, remap_dev=remap_dev):
            b = bucket_idx(cols["__time"])
            return remap_dev.on(b.device)[
                torch.clamp(b, 0, n_remap - 1).long()
            ]

        vals_arr = np.asarray(new_vals, dtype=object)

        def decode(codes, vals_arr=vals_arr):
            return vals_arr[np.clip(codes, 0, len(vals_arr) - 1)]

        return ResolvedDim(spec, len(new_vals), codes_fn, decode)

    def codes_fn(cols):
        return bucket_idx(cols["__time"])

    starts_np = np.asarray(starts)

    def decode(codes, starts_np=starts_np):
        ms = starts_np[np.clip(codes, 0, len(starts_np) - 1)]
        return ms.astype("datetime64[ms]")

    return ResolvedDim(spec, card, codes_fn, decode)


# ---------------------------------------------------------------------------
# Aggregation lowering
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoweredAggs:
    """Aggregations split by merge class for the kernel ABI.

    Layout contract with ops/groupby.py: sum-class aggs (psum merges) are the
    columns of `sum_values`; min-class then max-class are the columns of
    `minmax_values`.  Column 0 of sum_values is always the hidden `__rows`
    presence counter."""

    sum_names: List[str]
    min_names: List[str]
    max_names: List[str]
    sketch_aggs: List[A.Aggregation]
    long_valued: Dict[str, bool]
    value_fns: Dict[str, Callable]  # name -> fn(cols) -> f32[R]
    mask_fns: Dict[str, Optional[Callable]]  # name -> extra-mask fn or None
    count_like: set = dataclasses.field(default_factory=set)  # COUNT aggs
    # agg name -> existing sum column it READS instead of owning one: an
    # unfiltered COUNT(*) is exactly the hidden __rows presence counter,
    # and a duplicate all-ones scatter column is pure waste (the scatter
    # cost scales with the column count)
    aliased: Dict[str, str] = dataclasses.field(default_factory=dict)


def _lower_aggs(
    aggs: Sequence[A.Aggregation], ds: DataSource
) -> LoweredAggs:
    la = LoweredAggs(["__rows"], [], [], [], {"__rows": True}, {}, {})
    la.value_fns["__rows"] = lambda cols: None  # ones; handled specially
    la.mask_fns["__rows"] = None

    def add(agg: A.Aggregation, extra_filter: Optional[Filter]):
        mask_fn = (
            compile_filter(extra_filter, ds) if extra_filter is not None else None
        )
        if isinstance(agg, A.FilteredAgg):
            inner_mask = compile_filter(agg.filter, ds)
            if mask_fn is None:
                combined = inner_mask
            else:
                outer = mask_fn
                combined = lambda cols: outer(cols) & inner_mask(cols)
            _add_base(agg.aggregator, combined)
            return
        _add_base(agg, mask_fn)

    def _add_base(agg: A.Aggregation, mask_fn):
        name = agg.name
        la.mask_fns[name] = mask_fn
        if isinstance(agg, A.Count):
            la.long_valued[name] = True
            la.count_like.add(name)
            if mask_fn is None:
                la.aliased[name] = "__rows"  # reuse the presence counter
                return
            la.sum_names.append(name)
            la.value_fns[name] = lambda cols: None  # ones
        elif isinstance(agg, (A.LongSum, A.DoubleSum)):
            field = agg.field_name
            la.sum_names.append(name)
            la.long_valued[name] = isinstance(agg, A.LongSum)
            la.value_fns[name] = _field_value_fn(field, ds)
            _add_null_skip(la, name, field, ds)
        elif isinstance(agg, (A.LongMin, A.DoubleMin)):
            field = agg.field_name
            la.min_names.append(name)
            la.long_valued[name] = isinstance(agg, A.LongMin)
            la.value_fns[name] = _field_value_fn(field, ds)
            _add_null_skip(la, name, field, ds)
        elif isinstance(agg, (A.LongMax, A.DoubleMax)):
            field = agg.field_name
            la.max_names.append(name)
            la.long_valued[name] = isinstance(agg, A.LongMax)
            la.value_fns[name] = _field_value_fn(field, ds)
            _add_null_skip(la, name, field, ds)
        elif isinstance(agg, A.DimCodeMax):
            # FD grouping pruning: max over raw dictionary codes (all rows
            # of a group share one code by the declared FD); decoded back
            # to the value at the API layer.  Codes < 2^24 represent
            # exactly in f32; null rows carry -1 and never win the max
            # unless the whole group is null (-1 decodes back to null)
            field = agg.field_name
            la.max_names.append(name)
            la.long_valued[name] = True
            la.value_fns[name] = lambda cols, f=field: cols[f].to(
                torch.float32
            )
        elif isinstance(agg, A.ExpressionAgg):
            fn = compile_expr(agg.expression, ds.dicts)
            target = {
                "doubleSum": la.sum_names,
                "longSum": la.sum_names,
                "doubleMin": la.min_names,
                "doubleMax": la.max_names,
            }[agg.base]
            target.append(name)
            la.long_valued[name] = agg.base == "longSum"
            dicts = ds.dicts
            la.value_fns[name] = lambda cols, fn=fn, dicts=dicts: as_tensor(
                fn(DecodedView(cols, dicts)), cols["__valid"]
            ).to(torch.float32)
        elif sketch_ops(agg) is not None:
            la.sketch_aggs.append(agg)
            la.long_valued[name] = True
        else:
            raise NotImplementedError(f"aggregation {type(agg).__name__}")

    for agg in aggs:
        add(agg, None)
    return la


def _field_value_fn(field: str, ds: DataSource):
    """Value reader for sum/min/max: metric columns pass through; numeric-
    dictionary dimension columns decode rank codes back to values (so
    sum(d_year)-style aggregates see years, not ranks)."""
    d = ds.dicts.get(field) if hasattr(ds.dicts, "get") else None
    if d is not None and d.numeric_values is not None:
        dicts = ds.dicts
        return lambda cols, field=field, dicts=dicts: DecodedView(cols, dicts)[
            field
        ].to(torch.float32)
    return lambda cols, field=field: cols[field].to(torch.float32)


def _add_null_skip(la: LoweredAggs, name: str, field: str, ds: DataSource):
    """SQL aggregates skip NULLs: for a dictionary-dimension field, rows with
    a null code (-1) must not contribute (they'd otherwise decode to -1 and
    poison SUM/MIN/MAX).  Metrics have no null representation — no-op."""
    d = ds.dicts.get(field) if hasattr(ds.dicts, "get") else None
    if d is None:
        return
    nm = lambda cols, field=field: cols[field] >= 0
    prev = la.mask_fns.get(name)
    la.mask_fns[name] = (
        nm if prev is None else lambda cols, p=prev, nm=nm: p(cols) & nm(cols)
    )


# ---------------------------------------------------------------------------
# Query lowering
# ---------------------------------------------------------------------------


def row_mask(cols, intervals, filter_fn) -> torch.Tensor:
    """A segment's row mask on its device: valid rows inside the query
    intervals (half-open) that pass the filter."""
    mask = cols["__valid"]
    if intervals:
        t = cols["__time"]
        im = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        for a, b in intervals:
            im = im | ((t >= a) & (t < b))
        mask = mask & im
    if filter_fn is not None:
        mask = mask & filter_fn(cols)
    return mask


@dataclasses.dataclass
class GroupByLowering:
    """A GroupByQuery lowered to device-executable pieces:

    * `columns` — physical columns to fetch per segment
    * `row_arrays(cols)` — the row-wise pipeline producing
      (gid, mask, sum_values, minmax_values, minmax_masks)
    * `dims` / `la` / `num_groups` — the finalization contract
    """

    query: Q.GroupByQuery
    dims: List[ResolvedDim]
    la: LoweredAggs
    num_groups: int
    columns: List[str]
    filter_fn: Optional[Callable]
    vcol_fns: Dict[str, Callable]
    # vcol names that are ALSO read by a vcol expression (physical shadow)
    shadowed_inputs: frozenset = frozenset()

    def add_virtual(self, cols: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Compute virtual columns from the PHYSICAL inputs.  Idempotent:
        a virtual column that shadows a physical column it reads saves the
        physical values under __phys__<name>, so a second application
        recomputes from the same inputs instead of compounding."""
        if not self.vcol_fns:
            return cols
        inputs = dict(cols)
        # restore/save ALL physical shadows before any compute: a vcol
        # declared before a later-declared shadow still reads the
        # physical values on a second application
        for name in self.shadowed_inputs:
            phys = "__phys__" + name
            if phys in cols:
                inputs[name] = cols[phys]
            elif name in cols:
                cols[phys] = cols[name]
        for name, fn in self.vcol_fns.items():  # declaration order
            out = as_tensor(fn(inputs), cols["__valid"])
            cols[name] = out
            if name not in self.shadowed_inputs:
                # chained vcols: a LATER vcol may read this output; a
                # shadowed name keeps exposing its physical values to
                # vcol expressions instead
                inputs[name] = out
        return cols

    def row_mask(self, cols) -> torch.Tensor:
        return row_mask(cols, self.query.intervals, self.filter_fn)

    def row_arrays(
        self,
        cols: Dict[str, torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        gid: Optional[torch.Tensor] = None,
    ):
        """cols: name -> row-aligned device tensor (must include "__valid",
        and "__time" when the query touches time).  Returns the kernel ABI
        tuple for ops/groupby.py.

        `mask` and `gid` take a row pipeline computed already: in a fused
        batch (`serve.fusion.shared_row_plan`) members whose virtual
        columns, filter and intervals (for the mask) or virtual columns,
        dimensions, granularity and intervals (for the group ids) are
        identical compute them once a segment."""
        cols = dict(cols)
        self.add_virtual(cols)
        if mask is None:
            mask = self.row_mask(cols)
        la = self.la
        if gid is None:
            gid, _ = combine_group_ids(
                [d.codes_fn(cols) for d in self.dims],
                [d.cardinality for d in self.dims],
            )
            if gid is None:
                gid = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
        R = mask.shape[0]
        dev = mask.device
        maskf = mask.to(torch.float32)
        sum_cols = []
        for n in la.sum_names:
            base = la.value_fns[n](cols) if la.value_fns[n] is not None else None
            v = maskf if base is None else base * maskf
            mfn = la.mask_fns.get(n)
            if mfn is not None:
                v = v * mfn(cols).to(torch.float32)
            sum_cols.append(v)
        sum_values = torch.stack(sum_cols, dim=1)
        mm_names = la.min_names + la.max_names
        if mm_names:
            mm_vals, mm_masks = [], []
            for n in mm_names:
                mm_vals.append(la.value_fns[n](cols))
                mfn = la.mask_fns.get(n)
                mm_masks.append(
                    mfn(cols) if mfn is not None
                    else torch.ones((R,), dtype=torch.bool, device=dev)
                )
            minmax_values = torch.stack(mm_vals, dim=1)
            minmax_masks = torch.stack(mm_masks, dim=1)
        else:
            minmax_values = torch.zeros((R, 0), dtype=torch.float32, device=dev)
            minmax_masks = torch.zeros((R, 0), dtype=torch.bool, device=dev)
        return gid, mask, sum_values, minmax_values, minmax_masks


def _query_key(q: Q.QuerySpec, ds: DataSource) -> Tuple:
    """Identity of (query, datasource-schema) for the lowering cache."""
    import json as _json

    return (
        _json.dumps(q.to_druid(), sort_keys=True, default=str),
        schema_signature(ds),
    )


def schema_signature(ds: DataSource) -> Tuple:
    """Identity of a datasource's schema for the lowering cache: name + per-column
    kind/cardinality + dictionary content + segment ids.  Dictionary content
    matters because rank codes are data-dependent: re-ingesting a same-name
    datasource with an equal-cardinality but different value domain must MISS
    the cache (compiled filters bake in literal->code translations)."""
    return (
        ds.name,
        _dict_signature(ds),
        tuple(s.uid for s in ds.segments),
    )


def memo_key(q: Q.QuerySpec, ds: DataSource) -> Tuple:
    """Identity of (query, datasource schema) for what the engine learns
    about a query: its adaptive kept sets and declines, its sparse rungs.
    Unlike `_query_key` it leaves out the segment set, so an append keeps
    the learned rungs; dictionary content stays in, because a dictionary
    extension changes what the codes mean."""
    import json as _json

    return (
        _json.dumps(q.to_druid(), sort_keys=True, default=str),
        ds.name,
        _dict_signature(ds),
    )


def _dict_signature(ds: DataSource) -> Tuple:
    return tuple(
        (
            c.name,
            c.kind,
            c.cardinality,
            ds.dicts[c.name].content_key if c.name in ds.dicts else None,
        )
        for c in ds.columns
    )


def timeseries_to_groupby(q: Q.TimeseriesQuery) -> Q.GroupByQuery:
    """Timeseries->GroupBy rewrite (a Timeseries is a GroupBy whose only
    dimension is the time bucket)."""
    return Q.GroupByQuery(
        datasource=q.datasource,
        dimensions=(
            DimensionSpec(
                "__time", q.output_name, granularity=q.granularity
            ),
        ),
        aggregations=q.aggregations,
        post_aggregations=q.post_aggregations,
        filter=q.filter,
        intervals=q.intervals,
        virtual_columns=q.virtual_columns,
    )


def topn_to_groupby(q: Q.TopNQuery) -> Q.GroupByQuery:
    """TopN->GroupBy rewrite (exact TopN: full groupby then rank; Druid's
    native TopN is approximate — this one is exact and still one kernel)."""
    return Q.GroupByQuery(
        datasource=q.datasource,
        dimensions=(q.dimension,),
        aggregations=q.aggregations,
        post_aggregations=q.post_aggregations,
        filter=q.filter,
        intervals=q.intervals,
        granularity=q.granularity,
        virtual_columns=q.virtual_columns,
    )


def lower_groupby(q: Q.GroupByQuery, ds: DataSource) -> GroupByLowering:
    dims = _resolve_dims(q.dimensions, ds, q.intervals)
    la = _lower_aggs(q.aggregations, ds)
    G = 1
    for d in dims:
        G *= d.cardinality
    if G > (1 << 26):
        raise ValueError(
            f"combined group cardinality {G} too large for dense domain; "
            "sort-based path not yet wired for this size"
        )
    filter_fn = compile_filter(q.filter, ds) if q.filter is not None else None
    vcol_fns = {
        v.name: _decoded_expr_fn(v.expression, ds) for v in q.virtual_columns
    }
    # Shadowing a VALUE-SPACE (metric/numeric) column is supported: every
    # consumer reads plain values.  Shadowing a dictionary-encoded
    # dimension is REFUSED: filters/aggs/dims on dictionary names compile
    # into code space, and a value-space virtual array under that name
    # would be silently mis-evaluated (refuse rather than be wrong).
    for v in q.virtual_columns:
        if v.name in ds.dicts:
            raise ValueError(
                f"virtual column {v.name!r} shadows dictionary-encoded "
                f"dimension {v.name!r} of {ds.name!r}: filters and "
                "groupings on dictionary dimensions evaluate in code "
                "space, so the shadow cannot be honored soundly.  Name "
                "the virtual column differently."
            )
    vcol_inputs = {
        c for v in q.virtual_columns for c in v.expression.columns()
    }
    phys_names = {c.name for c in ds.columns}
    return GroupByLowering(
        q,
        dims,
        la,
        G,
        _needed_columns(q, ds, dims),
        filter_fn,
        vcol_fns,
        shadowed_inputs=frozenset(vcol_fns) & vcol_inputs & phys_names,
    )


def _decoded_expr_fn(expression, ds: DataSource):
    """Compile an expression so dimension references read decoded values."""
    fn = compile_expr(expression, ds.dicts)
    dicts = ds.dicts
    return lambda cols, fn=fn, dicts=dicts: fn(DecodedView(cols, dicts))


def _needed_columns(q, ds: DataSource, dims) -> List[str]:
    names: List[str] = []
    for d in dims:
        if d.spec.dimension != "__time" and d.spec.granularity is None:
            names.append(d.spec.dimension)
    for a in q.aggregations:
        names.extend(_agg_columns(a))
    if q.filter is not None:
        names.extend(_filter_columns(q.filter))
    for v in q.virtual_columns:
        names.extend(v.expression.columns())
    virt = {v.name for v in q.virtual_columns}
    # A name produced by a virtual column is not fetched — UNLESS it is a
    # SHADOW: a physical column that a vcol expression also reads (the vcol
    # computes from the physical values, every other consumer reads the
    # virtual ones).  A vcol name read only by ANOTHER vcol (chained
    # virtual columns) is not physical and must not be fetched.
    phys = {c.name for c in ds.columns}
    vcol_inputs = {
        c for v in q.virtual_columns for c in v.expression.columns()
    }
    shadows = virt & vcol_inputs & phys
    need = [
        n
        for n in dict.fromkeys(names)
        if (n not in virt or n in shadows) and n != "__time"
    ]
    if ds.time_column and (
        any(d.spec.dimension == "__time" or d.spec.granularity for d in dims)
        or q.intervals
        or "__time" in names
    ):
        need.append(ds.time_column)
    return need


def empty_partials(la: LoweredAggs, G: int, device):
    """Zero-row partial state (identity of every merge class) for a query
    whose segments were all pruned away."""
    sums = torch.zeros((G, len(la.sum_names)), dtype=torch.float32, device=device)
    mins = torch.full(
        (G, len(la.min_names)), float("inf"), dtype=torch.float32, device=device
    )
    maxs = torch.full(
        (G, len(la.max_names)), -float("inf"), dtype=torch.float32, device=device
    )
    sketch_states = {
        agg.name: sketch_ops(agg).empty_state(agg, G, device) for agg in la.sketch_aggs
    }
    return sums, mins, maxs, sketch_states


def sketch_ops(agg: A.Aggregation):
    """The ops module of a sketch aggregator's state, the one place that
    maps sketch types to modules: `ops/hll` (hyperUnique, cardinality),
    `ops/theta` or `ops/quantiles`, each with `partial(agg, cols, gid,
    mask, G)`, `merge_states(a, b, agg)`, `finalize(agg, state)`,
    `empty_state` and `to_reference_state`; None for an aggregator that is
    not a sketch."""
    if isinstance(agg, (A.HyperUnique, A.CardinalityAgg)):
        return hll
    if isinstance(agg, A.ThetaSketch):
        return theta
    if isinstance(agg, A.QuantilesSketch):
        return quantiles
    return None


def groupby_with_time_granularity(q: Q.GroupByQuery) -> Q.GroupByQuery:
    """Druid semantics: a non-'all' granularity on
    GroupBy adds an implicit leading time-bucket dimension (one result row
    per bucket per group)."""
    if q.granularity in ("all", None) or any(
        d.dimension == "__time" or d.granularity for d in q.dimensions
    ):
        return q
    return dataclasses.replace(
        q,
        dimensions=(
            DimensionSpec("__time", "timestamp", granularity=q.granularity),
        )
        + tuple(q.dimensions),
        granularity="all",
    )


def _agg_columns(a: A.Aggregation) -> List[str]:
    if isinstance(a, A.FilteredAgg):
        return _filter_columns(a.filter) + _agg_columns(a.aggregator)
    if isinstance(a, A.ExpressionAgg):
        return list(a.expression.columns())
    if isinstance(a, A.Count):
        return []
    if isinstance(a, A.CardinalityAgg):
        return list(a.field_names)
    return [a.field_name]  # type: ignore[attr-defined]


def _filter_columns(f: Filter) -> List[str]:
    from ..models import filters as F

    if isinstance(f, (F.Selector, F.InFilter, F.Bound, F.Regex, F.LikeFilter)):
        return [f.dimension]
    if isinstance(f, (F.And, F.Or)):
        out: List[str] = []
        for x in f.fields:
            out.extend(_filter_columns(x))
        return out
    if isinstance(f, F.Not):
        return _filter_columns(f.field)
    if isinstance(f, F.IntervalFilter):
        return ["__time"] if f.dimension == "__time" else [f.dimension]
    if isinstance(f, F.ExpressionFilter):
        return list(f.expression.columns())
    return []
