"""The cost model: each query's kernel class on one card.

Four classes answer a group-by, and the model prices each in microseconds
from the session's calibrated constants (`SessionConfig`, measured on the
device by `plan/calibrate.py`):

* **dense**: the one-hot class, `rows x cost_per_row_dense x tiles`, where a
  tile is `dense_tile_groups` groups.  On a card it is the hand-written
  kernel (`ops/cuda_groupby`), which reads its rows once whatever G is, and
  takes at most SCATTER_CUTOVER groups: above that it is priced inf,
  whatever `dense_max_groups` says.  On the CPU it is the kernel's plain
  version, a one-hot product whose cost grows with G;
* **segment**: the `index_add_` scatter, its per-row cost interpolated in
  log G between two calibrated domains, plus its dense state per segment;
* **sparse**: the sort-compaction tier (`exec/sparse_exec`), a compaction
  pass over every row and a sort-reduce over the survivors' capacity rung;
* **adaptive**: dictionary-domain compaction (`exec/adaptive_exec`), a
  presence probe amortized over repeats plus the best of dense and segment
  at the compacted domain G x selectivity.

`choose_physical` is the planner's decision (`Rewrite.physical`): the
class, and, where the context sees more than one device, whether the query
runs on the mesh (`parallel/distributed.py`): the per-shard compute from
the same model at the per-device shape, plus the merge's bytes over
`collective_bytes_per_us` and one dispatch, against the single-device
cost, the reference's rule.  `choose_merge_tree` prices the flat and the
hierarchical merge of a slice mesh; `groupby_state_bytes` is the state the
merge moves.
`choose_kernel_strategy` the class at one (rows, G) for a caller without a
plan: the adaptive tier's compacted pass and the stream.  The engine maps
"dense" onto the kernel on a card and onto its plain version on the CPU
(`Engine._resolve_strategy`).

The reference prices dense by 128-group tiles, after its accelerator's
vector lanes; the port's tile width is its own, measured on the card
(`dense_tile_groups`).  With `dense_tile_groups=128` and the same constants
the two models agree, the mesh half included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..catalog.segment import DataSource
from ..config import SessionConfig
from ..models import aggregations as A
from ..models import filters as F
from ..models import query as Q
from ..ops.filters import numeric_dict_code_bounds
from ..ops.groupby import SCATTER_CUTOVER
from ..ops.sparse_groupby import ROW_CAPACITY_LADDER

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class PhysicalPlan:
    """The planner's execution decision for one query spec."""

    query: Q.QuerySpec
    strategy: str  # "dense" | "segment" | "sparse" | "adaptive"
    distributed: bool  # run on the mesh
    mesh_shape: Optional[Tuple[int, int]]  # (data, groups) when distributed
    est_cost_local: float
    est_cost_dist: float
    num_groups: int
    rows: int

    def describe(self) -> str:
        tgt = (
            f"mesh(data={self.mesh_shape[0]}, groups={self.mesh_shape[1]})"
            if self.distributed and self.mesh_shape
            else "single-device"
        )
        return (
            f"TPUAggregateScan[strategy={self.strategy}, target={tgt}, "
            f"groups={self.num_groups}, rows={self.rows}, "
            f"cost(local)={self.est_cost_local:.3g}, "
            f"cost(dist)={self.est_cost_dist:.3g}]"
        )


def groupby_state_bytes(q: Q.QuerySpec, num_groups: int, cfg: Optional[SessionConfig]) -> int:
    """Bytes of per-group aggregate state the merge moves (the broker
    merge's payload): 4 per plain aggregate, an HLL's registers, a theta
    sketch's entries, and the hidden row counter."""
    per_group = 0
    for a in getattr(q, "aggregations", ()):
        base = a.aggregator if isinstance(a, A.FilteredAgg) else a
        if isinstance(base, (A.HyperUnique, A.CardinalityAgg)):
            per_group += 4 * (1 << base.precision)
        elif isinstance(base, A.ThetaSketch):
            per_group += 4 * base.size
        else:
            per_group += 4
    return (per_group + 4) * num_groups  # +4: hidden __rows counter


def choose_merge_tree(
    state_bytes: int,
    n_slices: int,
    nd_per_slice: int,
    cfg: SessionConfig,
) -> Tuple[str, float, float]:
    """The merge tree of a slice mesh's partial states: (tree, flat_us,
    hier_us), tree "flat" or "hierarchical".

    * flat: one ring all-reduce over slice x data, 2(N-1)/N x bytes, every
      hop priced at the slice link's rate (`dcn_bytes_per_us`) because the
      ring crosses the slice boundary;
    * hierarchical: an all-reduce within each slice at the collective rate,
      then one of the merged state across slices at the slice link's rate.

    With one slice the ring never leaves it (flat is priced at the
    collective rate and the trees coincide); flat wins ties."""
    n = max(1, n_slices * nd_per_slice)
    flat_bw = cfg.dcn_bytes_per_us if n_slices > 1 else cfg.collective_bytes_per_us
    flat_us = 2.0 * (n - 1) / n * state_bytes / max(1.0, flat_bw)
    hier_us = 2.0 * (nd_per_slice - 1) / max(1, nd_per_slice) * (
        state_bytes / max(1.0, cfg.collective_bytes_per_us)
    ) + 2.0 * (n_slices - 1) / max(1, n_slices) * (
        state_bytes / max(1.0, cfg.dcn_bytes_per_us)
    )
    tree = "hierarchical" if hier_us < flat_us else "flat"
    return tree, flat_us, hier_us


def on_card(device) -> bool:
    """Whether `device` is a card (the kernel's device)."""
    return device is not None and torch.device(device).type == "cuda"


def _g_tiles(num_groups: int, cfg: SessionConfig) -> int:
    """Tiles of `dense_tile_groups` groups the dense class spans."""
    return max(1, -(-num_groups // max(1, cfg.dense_tile_groups)))


def _dense_cost(rows: float, num_groups: int, cfg: SessionConfig, device) -> float:
    if num_groups > cfg.dense_max_groups or (on_card(device) and num_groups > SCATTER_CUTOVER):
        return _INF
    return rows * cfg.cost_per_row_dense * _g_tiles(num_groups, cfg)


def scatter_row_cost(num_groups: int, cfg: SessionConfig) -> float:
    """Per-row scatter cost at this domain: log-linear between the
    calibrated low-G and high-G points, clamped outside them.  A state that
    outgrows the cache costs more per row; the high point never prices
    below the low one."""
    lo_g = max(1, cfg.scatter_lo_groups)
    hi_g = max(lo_g + 1, cfg.scatter_hi_groups)
    lo = cfg.cost_per_row_scatter
    hi = max(cfg.cost_per_row_scatter_hi, lo)
    if num_groups <= lo_g:
        return lo
    if num_groups >= hi_g:
        return hi
    f = math.log(num_groups / lo_g) / math.log(hi_g / lo_g)
    return lo + (hi - lo) * f


def _kernel_costs(
    rows: int,
    num_groups: int,
    cfg: SessionConfig,
    sparse_ok: bool,
    selectivity: float = 1.0,
    n_segments: int = 1,
    adaptive_ok: bool = False,
    ndims: int = 1,
    device=None,
) -> Tuple[Tuple[str, float], ...]:
    """(class, modelled us) for each kernel class (inf: inapplicable).
    `selectivity` is the filter's estimated surviving share; `n_segments`
    matters because the scatter's state and the sparse tier's sort are paid
    per segment.  The adaptive class is one presence probe over the rows
    (amortized over repeats: the kept-set cache skips it) plus the cheaper
    of dense and segment at G' = G x selectivity.  `device` is the
    executing device (None: the CPU's rules)."""
    n_segments = max(1, n_segments)
    dense = _dense_cost(rows, num_groups, cfg, device)

    def scatter_at(g: int) -> float:
        return rows * scatter_row_cost(g, cfg) + g * cfg.cost_per_group_state * n_segments

    scatter = scatter_at(num_groups)
    # the compaction reads at least what a scatter pass reads
    compact = max(cfg.cost_per_row_compact, cfg.cost_per_row_scatter)
    if not sparse_ok:
        sparse = _INF
    elif selectivity >= 1.0:
        sparse = rows * cfg.cost_per_row_sparse  # a full-segment sort
    else:
        # the smallest capacity rung covering the estimated survivors per
        # segment, sorted in every segment
        seg_rows = max(1.0, rows / n_segments)
        need = 2.0 * selectivity * seg_rows
        rung = next((c for c in ROW_CAPACITY_LADDER if c >= need), seg_rows)
        sorted_rows = n_segments * min(seg_rows, float(rung))
        sparse = rows * compact + sorted_rows * cfg.cost_per_row_sparse
    if not adaptive_ok:
        adaptive = _INF
    else:
        g_c = max(1, min(num_groups, round(num_groups * selectivity)))
        probe = rows * ndims * min(cfg.cost_per_row_dense, cfg.cost_per_row_scatter)
        main = min(scatter_at(g_c), _dense_cost(rows, g_c, cfg, device))
        # the probe and its dispatch amortized over repeats (/3)
        adaptive = (probe + cfg.cost_dispatch_us) / 3.0 + main
    return (
        ("dense", dense),
        ("segment", scatter),
        ("sparse", sparse),
        ("adaptive", adaptive),
    )


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


def choose_kernel_strategy(rows: int, num_groups: int, cfg: SessionConfig,
                           sparse_ok: bool = False, device=None) -> str:
    """The cheapest class at (rows, G) for a caller without a plan: the
    adaptive tier's compacted pass and the stream (dense or segment unless
    `sparse_ok`)."""
    return min(_kernel_costs(rows, num_groups, cfg, sparse_ok, device=device),
               key=lambda kv: kv[1])[0]


def query_kernel_costs(
    q: Q.QuerySpec,
    ds: DataSource,
    num_groups: int,
    cfg: SessionConfig,
    selectivity: Optional[float] = None,
    device=None,
) -> dict:
    """class -> modelled us for a planned query over `ds`.  Eligibility is
    the engine's: sparse needs dimensions, no sketch state and G above the
    cutover; adaptive needs dimensions and G above the cutover (it re-keys
    sketch states).  A TopN's dimension counts: the engine runs it as a
    GroupBy over it, tiers included (the reference reads `dimensions`
    alone, which a TopN lacks, and prices only dense and segment there)."""
    rows = ds.num_rows
    aggs = getattr(q, "aggregations", ())
    has_sketch = any(
        isinstance(a.aggregator if isinstance(a, A.FilteredAgg) else a,
                   (A.HyperUnique, A.CardinalityAgg, A.ThetaSketch))
        for a in aggs
    )
    dims = (q.dimension,) if isinstance(q, Q.TopNQuery) else getattr(q, "dimensions", ())
    sparse_ok = num_groups > SCATTER_CUTOVER and not has_sketch and bool(dims)
    adaptive_ok = num_groups > SCATTER_CUTOVER and bool(dims)
    segs = getattr(ds, "segments", None)
    n_segments = len(segs) if segs is not None else max(1, rows // (1 << 22))
    sel = (selectivity if selectivity is not None
           else estimate_selectivity(getattr(q, "filter", None), ds))
    return dict(_kernel_costs(rows, num_groups, cfg, sparse_ok, selectivity=sel,
                              n_segments=n_segments, adaptive_ok=adaptive_ok,
                              ndims=max(1, len(dims)), device=device))


def choose_query_kernel(
    q: Q.QuerySpec,
    ds: DataSource,
    num_groups: int,
    cfg: SessionConfig,
    exclude: Tuple[str, ...] = (),
    costs: Optional[dict] = None,
    device=None,
) -> str:
    """The cheapest class for a planned query, less `exclude`; `costs` a
    `query_kernel_costs` already computed.  With the model off: dense where
    it is priced (G <= dense_max_groups, and <= SCATTER_CUTOVER on a card),
    else sparse where it applies, else segment."""
    if costs is None:
        costs = query_kernel_costs(q, ds, num_groups, cfg, device=device)
    costs = {k: v for k, v in costs.items() if k not in exclude}
    if not cfg.cost_model_enabled:
        if costs.get("dense", _INF) != _INF:
            return "dense"
        if costs.get("sparse", _INF) != _INF:
            return "sparse"
        return "segment"
    return min(costs.items(), key=lambda kv: kv[1])[0]


def choose_physical(
    q: Q.QuerySpec,
    ds: DataSource,
    num_groups: int,
    cfg: SessionConfig,
    n_devices: int = 1,
    device=None,
) -> PhysicalPlan:
    """The kernel class of one query by modelled cost (us), and on
    `n_devices` > 1 (the shards of the context's device list) whether it
    runs on the mesh: a GroupBy-family query does when `prefer_distributed`
    is on and the mesh's modelled cost beats the single device's (always,
    with the model off).  The mesh is (data, groups): `mesh_groups_axis`
    shards the group domain, `mesh_data_axis` (default: the rest) the rows.
    The selectivity walk runs once."""
    sel = estimate_selectivity(getattr(q, "filter", None), ds)
    costs = query_kernel_costs(q, ds, num_groups, cfg, selectivity=sel, device=device)
    strategy = choose_query_kernel(q, ds, num_groups, cfg, costs=costs, device=device)
    local_cost = costs[strategy]
    rows = ds.num_rows
    aggregate_family = isinstance(q, (Q.GroupByQuery, Q.TimeseriesQuery, Q.TopNQuery))
    distributed = False
    mesh_shape = None
    dist_cost = local_cost
    if n_devices > 1 and aggregate_family:
        ng = max(1, cfg.mesh_groups_axis)
        nd = cfg.mesh_data_axis or max(1, n_devices // ng)
        nd = min(nd, max(1, n_devices // ng))
        # rows shard over the data axis, the group domain over the groups
        # axis; each shard's compute is the same model at its own shape
        per_device_groups = -(-num_groups // ng)
        compute = dict(_kernel_costs(
            max(1, rows // nd), per_device_groups, cfg,
            sparse_ok=strategy == "sparse",
            selectivity=sel,
            n_segments=1,  # one shard per device
            adaptive_ok=strategy == "adaptive",
            ndims=max(1, len(getattr(q, "dimensions", ()) or ())),
            device=device,
        ))[strategy]
        # the bytes the merge moves: the dense classes all-reduce the
        # [Gl, M] state; the sparse rung all-gathers slot-compacted states
        # and adaptive merges the compacted domain, both bounded by the
        # populated groups (~ G x selectivity)
        if strategy in ("sparse", "adaptive"):
            g_eff = max(1, min(per_device_groups, round(num_groups * sel)))
            state_bytes = groupby_state_bytes(q, g_eff, cfg)
            factor = float(nd - 1)  # an all-gather moves (nd - 1) states
        else:
            state_bytes = groupby_state_bytes(q, per_device_groups, cfg)
            factor = 2.0 * (nd - 1) / nd  # a ring all-reduce
        collective = factor * state_bytes / max(cfg.collective_bytes_per_us, 1e-9)
        dist_cost = compute + collective + cfg.cost_dispatch_us
        distributed = cfg.prefer_distributed and (
            not cfg.cost_model_enabled or dist_cost < local_cost
        )
        if distributed:
            mesh_shape = (nd, ng)
    return PhysicalPlan(
        query=q,
        strategy=strategy,
        distributed=distributed,
        mesh_shape=mesh_shape,
        est_cost_local=local_cost,
        est_cost_dist=dist_cost,
        num_groups=num_groups,
        rows=rows,
    )
