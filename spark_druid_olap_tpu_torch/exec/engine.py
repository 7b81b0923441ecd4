"""Single-device query engine: QuerySpec x DataSource -> pandas DataFrame.

`Engine.execute` runs a Druid-native query spec over a datasource's
segments.  A GroupBy, Timeseries or TopN runs as follows:

1. `segments_in_scope` prunes segments by the query interval and by
   per-segment zone maps;
2. each in-scope segment's needed columns move to the device once and stay
   resident under a byte budget (the analog of Druid's segment residency);
3. per segment, `GroupByLowering.row_arrays` builds the filter mask, the
   combined group id and the pre-masked value columns, and
   `ops/groupby.partial_aggregate` reduces them to [G, M] partial states —
   on a CUDA device through the hand-written kernel (`ops/cuda_groupby.py`)
   for G <= SCATTER_CUTOVER.  Above it the high-cardinality tiers go first:
   adaptive domain compaction (`exec/adaptive_exec.py`) runs the kernel over
   the codes present under the filter, the sparse tier
   (`exec/sparse_exec.py`) over the present group ids compacted to slots,
   and the scatter path runs only after both declined.  Which of these
   runs is the execution's strategy: an argument of each entry point (a
   context passes its plan's class, `plan/cost.choose_physical`), else the
   engine's own `strategy`.  From the same group ids and mask,
   `sketch_partials` builds each sketch aggregator's partial state (HLL
   registers, theta hash sets, quantile samples: `ops/hll.py`,
   `ops/theta.py`, `ops/quantiles.py`);
4. the partials fold in canonical segment order (sums add, min/max take
   `torch.minimum`/`torch.maximum`, sketches merge by type), so a query's
   float sums and sketch states are bit-identical from run to run;
5. only the merged state comes back to the host, in one fetch, where
   `exec/finalize.py` decodes groups, finalizes sketches, evaluates
   post-aggregations, having and limit, and builds the DataFrame.

Steps 3 and 4 run as one host call per query scope where they can: the
arena (`exec/arena.py`) captures a scope's segment loop as a CUDA graph on
its second execution and replays it after; otherwise the eager loop runs.
A column that is not resident reaches the card through the transfer
pipeline (`exec/pipeline.py`): from a pinned host copy kept per column.
`execute_groupby_batch` dispatches several group-bys before it fetches any
(grouping sets).  `configure_pipeline` applies the session's
`transfer_pipeline` and `arena_execution`.

Resilience (`resilience.py`): a group-by execution runs under
`run_device_attempts`, so a transient failure evicts the query's lowering,
its arena programs and the datasource's resident columns and runs again,
each outcome reported to `Engine.breaker`.  Every loop checkpoints between
segments (`engine.segment_loop`, `engine.scan_loop`, `engine.search_loop`,
and `engine.resolve` before the fetch); under an armed partial collector a
deadline that expires there stops the loop and the partials merged so far
are the answer, their coverage accounted on the collector.  The fault
sites `device_dispatch` (before each dispatch) and `h2d` (before each cold
column's copy) fire on the host.  `execute_progressive` yields one
refinement per segment.

Serving (`serve/`): `execute_fused` runs a micro-batch of concurrent
GroupBy-family queries as one execution (over resident segments one
captured CUDA graph and one fetch, `exec/arena.py`), and `fusable` says
which queries may join one.  The device half of every execution (the
tiers, capture, replay, the eager loops) and its fetch, and every
eviction, run under the engine's execution lock (`_exec_lock`; a Scan or
Search takes it one segment at a time), so one engine serves the server's
handler threads: their host work (decoding, planning, lowering, the
finalizing, a retry's backoff, the response) runs beside another query's
device work, their device work one at a time.

Tracing (`obs/`): under an active query trace the engine opens the `lower`,
`h2d`, `segment_dispatch`, `arena_build`, `device_fetch` and `finalize`
spans, stamps the trace's query_id on its QueryMetrics and publishes each
finished execution into the metrics registry.  On a sampled query
(`SessionConfig.prof_sample_rate`) each dispatch is timed by CUDA events.

A Scan builds each in-scope segment's row mask (intervals, filter) on the
device over the resident columns, compacts the selected rows there and
copies them to the host in one transfer per segment (`_fetch_rows`); an
unordered LIMIT stops the loop early, and an ordered LIMIT keeps each
segment's top limit+offset rows before the concat.  A Search takes its
candidate values from the host dictionaries, then counts the matching rows
per code with `torch.bincount` on the device.  TimeBoundary,
DataSourceMetadata and SegmentMetadata read catalog metadata and dispatch
no device work.

Ingest (`ingest/`): a delta segment is one more segment in scope.
`evict_segments` drops the device columns, pinned host copies and arena
programs of retired segment uids (a remap, a compaction), so no graph
replays over a freed column.  For the result cache's delta reuse,
`state_capture` keeps an execution's merged host partial state,
`groupby_partials_host` computes one over chosen segments (through the
arena), and `merge_groupby_states` / `finalize_groupby_state` merge and
finalize them on the host (the merge never touches the card, so it needs
no execution lock).

Entry points run on CUDA unless the caller passes `device="cpu"`; with no
device given and no GPU present, `Engine()` raises.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..catalog.segment import DataSource, Segment, row_counts
from ..config import SessionConfig
from ..models import filters as F
from ..models import query as Q
from ..models.filters import _ms_to_iso
from ..ops.filters import compile_filter, numeric_dict_code_bounds
from ..ops.groupby import SCATTER_CUTOVER, partial_aggregate, resolve_strategy
from ..obs import (
    SPAN_DEVICE_FETCH,
    SPAN_FINALIZE,
    SPAN_H2D,
    SPAN_LOWER,
    SPAN_SEGMENT_DISPATCH,
    current_query_id,
    current_trace,
    prof,
    record_query_metrics,
    span,
)
from ..plan.expr import as_tensor
from ..resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    checkpoint,
    checkpoint_partial,
    classify_error,
    current_partial,
    fire,
    run_device_attempts,
)
from ..utils.log import get_logger
from ..utils.lru import ByteBudgetCache, CountBudgetCache
from . import arena
from .adaptive_exec import AdaptiveDomainMixin
from .finalize import (
    apply_limit_spec,
    finalize_groupby,
    finalize_timeseries,
    finalize_topn,
)
from .lowering import (
    GroupByLowering,
    LoweredAggs,
    _decoded_expr_fn,
    _filter_columns,
    _query_key,
    empty_partials,
    groupby_with_time_granularity,
    lower_groupby,
    memo_key,
    row_mask,
    sketch_ops,
    timeseries_to_groupby,
    topn_to_groupby,
)
from .metrics import QueryMetrics
from .pipeline import TransferPipeline, column_key
from .sparse_exec import SparseExecMixin

log = get_logger("exec.engine")

_NO_SPAN = contextlib.nullcontext()


def _wire_type(q) -> str:
    """A query's Druid queryType, its metrics label."""
    try:
        return q.to_druid().get("queryType", type(q).__name__)
    except Exception:  # metrics labelling only
        return type(q).__name__


def _retryable(err: BaseException) -> bool:
    return classify_error(err) == "transient"


def _row_count(segs) -> int:
    """Real rows of a segment list: the unit of partial-result coverage."""
    return sum(s.num_rows for s in segs)


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


def shard_partials(lowering: GroupByLowering, cols, strategy: str, memo=None, share=None):
    """One shard's partial state (sums, mins, maxs, sketch states) from its
    device columns: `row_arrays`, then `partial_aggregate`, then the sketch
    partials.  The segment loop and the streaming chunk loop both call it,
    so a chunk and a segment of the same rows run the same ops in the same
    order.  In a fused batch `memo` is the segment's dict of computed
    masks and group ids and `share` the member's (mask group, gid group)
    of `serve.fusion.shared_row_plan`: a member reuses an earlier member's
    identical mask or group ids."""
    la = lowering.la
    if la.sketch_aggs:
        cols = lowering.add_virtual(dict(cols))  # sketches read virtuals
    mask0 = gid0 = None
    if memo is not None and share is not None:
        mask0 = memo.get(("mask", share[0]))
        gid0 = memo.get(("gid", share[1]))
    gid, mask, sv, mmv, mmm = lowering.row_arrays(cols, mask=mask0, gid=gid0)
    if memo is not None and share is not None:
        memo.setdefault(("mask", share[0]), mask)
        memo.setdefault(("gid", share[1]), gid)
    s, mn, mx = partial_aggregate(
        gid, mask, sv, mmv, mmm,
        num_groups=lowering.num_groups,
        num_min=len(la.min_names),
        num_max=len(la.max_names),
        strategy=strategy,
    )
    sk = sketch_partials(lowering, cols, gid, mask) if la.sketch_aggs else {}
    return s, mn, mx, sk


def fold_partials(la: LoweredAggs, acc, part):
    """`acc` folded with one more shard's partial state, the accumulator
    first: sums add, min/max take `torch.minimum`/`torch.maximum`, sketches
    merge by type.  `acc` None starts the fold."""
    s, mn, mx, sk = part
    sketches: Dict[str, torch.Tensor] = {} if acc is None else acc[3]
    if acc is not None:
        s, mn, mx = acc[0] + s, torch.minimum(acc[1], mn), torch.maximum(acc[2], mx)
    merge_sketch_states(la, sketches, sk)
    return s, mn, mx, sketches


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


STRATEGIES = ("auto", "adaptive", "sparse", "segment", "cuda", "dense")


class Engine(AdaptiveDomainMixin, SparseExecMixin):
    """Executes GroupBy, Timeseries and TopN query specs on one device.

    `strategy` takes the reference's names:

    * "auto" (the default): at G <= SCATTER_CUTOVER the group-by kernel (its
      plain version on the CPU); above it the adaptive tier, then, on a
      card, the sparse tier, and the scatter path only after both declined;
    * "adaptive": the adaptive tier, then the sparse tier (on any device);
    * "sparse": the sparse tier alone above the cutover;
    * "segment": the scatter path at every G;
    * "cuda": the kernel at every G (it takes G <= SCATTER_CUTOVER);
    * "dense": the one-hot class: the kernel on a card, its plain version
      on the CPU, and on a card the sparse tier above the cutover (then
      the scatter: the card has no one-hot path that wide).

    Every entry point also takes a `strategy` for its own execution (a
    context passes its plan's; concurrent executions never share it);
    None is the engine's.  The adaptive tier's compacted pass and the
    stream ask the cost model at their own (rows, G), with `cost_config`
    (a context sets its session's; else the device's calibration,
    `SessionConfig.load_calibrated`).

    A tier declines only for the deterministic reasons it records in
    `QueryMetrics.declines`; an error raises."""

    def __init__(self, device=None, strategy: str = "auto"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
        self.device = resolve_device(device)
        self.strategy = strategy
        # the cost constants of the adaptive tier's compacted pass and the
        # stream (`cost_config`); a context sets its session's on each call
        self._cost_config: Optional[SessionConfig] = None
        # LRU residency of device columns under a byte budget; a column that
        # leaves it takes the arena programs that read it along
        self._device_cache = ByteBudgetCache(
            _default_device_budget(self.device), on_evict=self._on_evict)
        self._pipeline = TransferPipeline(self)
        self._arena = arena.ArenaCache()
        self.arena_execution = True
        self._graph_stream = None
        # one execution on the card at a time: capture, replay and copy-out,
        # the eager loops and eviction.  Reentrant (a batch runs its
        # queries' executions inside its own)
        self._exec_lock = threading.RLock()
        # residency per datasource for the `sdol_resident_bytes` gauge and
        # the eviction counter: key -> (datasource, bytes); the cache's keys
        # carry only segment uids
        self._resident_meta: Dict = {}
        self._resident_by_ds: Dict[str, int] = {}
        # (query json, datasource schema) -> GroupByLowering: lowering is
        # host work that also stages device constants
        self._lowering_cache = CountBudgetCache(LOWERING_CACHE_ENTRIES)
        self.last_metrics: Optional[QueryMetrics] = None
        # per thread: the holder `state_capture` armed for the next
        # execution's merged host state (the result cache's delta reuse)
        self._capture_local = threading.local()
        # what the tiers learn per query (memo_key): the adaptive kept sets
        # and declines, the sparse rungs, and the queries pinned off the
        # sparse tier because their groups overflow its top rung
        self._adaptive_kept: Dict = {}
        self._adaptive_declined: Dict = {}
        self._sparse_row_capacity: Dict = {}
        self._sparse_slots: Dict = {}
        self._sparse_disabled: Dict = {}
        # resilience: transient failures and recoveries are reported to the
        # breaker, and a group-by runs up to `_retry_attempts` times, both
        # from the session defaults; `api.TPUOlapContext` puts its own
        # breaker and the session's budget in their place
        cfg = SessionConfig()
        self.breaker = CircuitBreaker(failure_threshold=cfg.breaker_failure_threshold,
                                      cooldown_ms=cfg.breaker_cooldown_ms)
        self._retry_attempts = cfg.retry_max_attempts
        self._retry_backoff_ms = cfg.retry_backoff_ms

    def _kernel_class(self) -> str:
        """The one-hot kernel class on this engine's device: "cuda" (the
        hand-written kernel) on a card, its plain version "dense" on the
        CPU."""
        return resolve_strategy("auto", 1, self.device)

    def _resolve_strategy(self, num_groups: int, strategy: Optional[str] = None) -> str:
        """The kernel strategy of a pass over `num_groups` groups outside the
        tiers, under `strategy` (None: the engine's).  "dense" is the
        kernel's class: on a card the kernel, which takes at most
        SCATTER_CUTOVER groups (the scatter above), on the CPU its plain
        version."""
        s = self.strategy if strategy is None else strategy
        if s in ("auto", "adaptive", "sparse"):
            return resolve_strategy("auto", num_groups, self.device)
        if s == "dense":
            k = self._kernel_class()
            return "segment" if k == "cuda" and num_groups > SCATTER_CUTOVER else k
        return s

    @property
    def cost_config(self) -> SessionConfig:
        """The cost constants the adaptive tier and the stream price with:
        the context's session (set on each call), else the calibration of
        this engine's device, loaded once."""
        if self._cost_config is None:
            self._cost_config = SessionConfig.load_calibrated(device=self.device)
        return self._cost_config

    @cost_config.setter
    def cost_config(self, cfg: SessionConfig) -> None:
        self._cost_config = cfg

    def configure_pipeline(self, config) -> None:
        """Applies the session's execution flags (`api.TPUOlapContext` calls
        it at construction and on every SET): `transfer_pipeline` and
        `arena_execution`."""
        self._pipeline.configure(config)
        self.arena_execution = bool(config.arena_execution)

    def _capture_stream(self):
        """The side stream CUDA graphs are captured on."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        return self._graph_stream

    # -- segment residency ---------------------------------------------------

    def _on_evict(self, key, _value) -> None:
        """A column left the residency cache: drop the arena programs that
        hold it, and count it off its datasource's resident bytes."""
        self._arena.invalidate_column(key)
        meta = self._resident_meta.pop(key, None)
        if meta is not None:
            ds_name, nbytes = meta
            self._resident_by_ds[ds_name] -= nbytes
            prof.record_resident(ds_name, self._resident_by_ds[ds_name])
            prof.record_eviction(ds_name)

    def _device_col(self, key, host_fn, m: QueryMetrics, ds_name: str = "") -> torch.Tensor:
        """A resident column, else one copied now (`TransferPipeline.put`;
        on a sampled query the copy is waited for, so its time is the
        link's)."""
        t = self._device_cache.get(key)
        if t is not None:
            prof.note_residency(hit=True)
            return t
        prof.note_residency(hit=False)
        host = host_fn()
        fire("h2d")
        t0 = time.perf_counter()
        t = self._pipeline.put(key, host)
        prof.transfer_sync(self.device)
        dt = time.perf_counter() - t0
        m.h2d_ms += dt * 1e3
        m.h2d_bytes += int(host.nbytes)
        prof.record_h2d(int(host.nbytes), dt)
        self._device_cache[key] = t
        self._resident_meta[key] = (ds_name, int(host.nbytes))
        now = self._resident_by_ds.get(ds_name, 0) + int(host.nbytes)
        self._resident_by_ds[ds_name] = now
        prof.record_resident(ds_name, now)
        return t

    def _cols_for_segment(
        self, seg: Segment, ds: DataSource, names, m: QueryMetrics
    ) -> Dict[str, torch.Tensor]:
        keys = [column_key(seg, n) for n in names] + [column_key(seg)]
        # under a trace, a segment with a cold column copies inside an h2d span
        cold = current_trace() is not None and not all(k in self._device_cache for k in keys)
        with span(SPAN_H2D, segment=seg.uid) if cold else _NO_SPAN:
            cols = {
                n: self._device_col(k, lambda n=n: seg.column(n), m, ds.name)
                for n, k in zip(names, keys)
            }
            cols["__valid"] = self._device_col(keys[-1], lambda: seg.valid, m, ds.name)
        if ds.time_column and ds.time_column in cols:
            cols["__time"] = cols[ds.time_column]
        return cols

    def bytes_resident(self) -> int:
        """Device bytes held by the segment residency cache."""
        return self._device_cache.bytes_used

    def drop_residency(self):
        """Drop the arena programs (which hold resident columns) and the
        resident columns: the next query of any scope starts cold.
        Lowerings and pinned host copies stay."""
        with self._exec_lock:
            self._arena.clear()
            self._device_cache.clear()
            self._resident_meta.clear()
            for ds_name in self._resident_by_ds:
                self._resident_by_ds[ds_name] = 0
                prof.record_resident(ds_name, 0)

    def clear_cache(self):
        """`drop_residency`, and drop the pinned host copies and the cached
        lowerings (which close over staged device constants)."""
        with self._exec_lock:
            self.drop_residency()
            self._pipeline.clear()
            self._lowering_cache.clear()

    def evict_segments(self, uids) -> None:
        """Retire segment uids (a dictionary remap or a compaction replaced
        their segments): their device columns, the arena and fused programs
        and warm marks that read any of them, and their pinned host copies
        all go at once, so no graph ever replays over a freed column and no
        retired segment holds memory until LRU pressure."""
        uids = frozenset(uids)
        if not uids:
            return
        with self._exec_lock:
            self._arena.invalidate_uids(uids)
            for k in [k for k in self._device_cache if k[0] in uids]:
                self._device_cache.pop(k)  # on_evict: programs and accounting
            self._pipeline.retire(uids)

    def missing_resident_bytes(self, ds: DataSource, cols) -> int:
        """Bytes a query over `cols` would copy to the card before it runs:
        4 a row for each column and the validity mask of each segment not
        in the residency cache (a column held only as a pinned host copy
        still crosses the link); 0 when all are resident."""
        return sum(
            4 * seg.num_rows
            for seg in ds.segments
            for key in [column_key(seg, c) for c in cols] + [column_key(seg)]
            if key not in self._device_cache
        )

    def resident_uids(self) -> frozenset:
        """Uids of the segments with a column resident on the device."""
        return frozenset(k[0] for k in self._device_cache)

    # -- entry points --------------------------------------------------------

    def execute(self, q: Q.QuerySpec, ds: DataSource, strategy: Optional[str] = None):
        """One query's frame, a group-by under `strategy` (None: the
        engine's).  A group-by holds the execution lock across its device
        half and fetch only; a Scan or Search one segment at a time, so a
        long one does not hold the card from other queries; the metadata
        queries do no device work."""
        if isinstance(q, Q.GroupByQuery):
            return self._execute_groupby(q, ds, strategy)
        if isinstance(q, Q.TimeseriesQuery):
            df = self._execute_groupby(timeseries_to_groupby(q), ds, strategy)
            return finalize_timeseries(df, q, ds)
        if isinstance(q, Q.TopNQuery):
            df = self._execute_groupby(topn_to_groupby(q), ds, strategy)
            return finalize_topn(df, q)
        if isinstance(q, Q.ScanQuery):
            return self._execute_scan(q, ds)
        if isinstance(q, Q.SearchQuery):
            return self._execute_search(q, ds)
        if isinstance(q, Q.TimeBoundaryQuery):
            return self._execute_time_boundary(q, ds)
        if isinstance(q, Q.DataSourceMetadataQuery):
            return self._execute_datasource_metadata(q, ds)
        if isinstance(q, Q.SegmentMetadataQuery):
            return self._execute_segment_metadata(q, ds)
        raise NotImplementedError(type(q).__name__)

    # -- groupby -------------------------------------------------------------

    def _lowering_for(self, q: Q.GroupByQuery, ds: DataSource) -> GroupByLowering:
        key = _query_key(q, ds)
        lowering = self._lowering_cache.get(key)
        if lowering is None:
            lowering = lower_groupby(q, ds)
            self._lowering_cache[key] = lowering
        return lowering

    def tiers(self, q: Q.QuerySpec, ds: DataSource, strategy: Optional[str] = None) -> List[str]:
        """The paths this engine tries for a group-by under `strategy`
        (None: the engine's), in order: the tiers that apply to it, then
        the kernel strategy that answers when they decline."""
        if isinstance(q, Q.TimeseriesQuery):
            q = timeseries_to_groupby(q)
        elif isinstance(q, Q.TopNQuery):
            q = topn_to_groupby(q)
        q = groupby_with_time_granularity(q)
        lowering = self._lowering_for(q, ds)
        out = []
        if self._adaptive_eligible(lowering, strategy):
            out.append("adaptive")
        if self._sparse_eligible(lowering, strategy):
            out.append("sparse")
        return out + [self._resolve_strategy(lowering.num_groups, strategy)]

    def _partials_for_query(
        self, lowering: GroupByLowering, segs, ds: DataSource, strategy: str,
        m: QueryMetrics, key_extra=(),
    ):
        """The scope's partial state by `strategy`, folded in canonical
        segment order on the device: from the arena's program where it has
        one (`key_extra` tells a compacted lowering's program from
        another's), else from the eager loop.  Returns (sums, mins, maxs,
        sketch states); the empty state when no segment is in scope or a
        deadline stopped the pass before its first segment.  The pass's
        scope is declared to the partial collector."""
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))
        state = None
        if segs:
            plan = arena.plan_for(self, lowering, segs, strategy, key_extra, ds, m)
            if plan is not None:
                state = arena.run_plan(self, ds, plan, m)
            if state is None:
                state = self._segment_loop(lowering, segs, ds, strategy, m)
                if plan is not None:
                    self._arena.note_warm(plan)
        if state is None:
            # every segment pruned (a complete zero-row answer), or a
            # deadline before the first segment
            state = empty_partials(lowering.la, lowering.num_groups, self.device)
        return state

    def _arena_program(self, plan: "arena.ArenaPlan", ds: DataSource, m: QueryMetrics):
        """The scope's arena program from the program cache; built (on a card,
        captured) on the scope's second execution over its resident columns;
        None on its first, which runs the eager loop.  A chunked program
        builds each chunk when its replays first reach it."""
        prog = self._arena.get(plan.key)
        prof.note_program_cache("arena", hit=prog is not None)
        if prog is not None:
            # a replay reads the columns: they stay as recent as the loop's
            # reads would keep them
            self._device_cache.touch(plan.col_keys)
            return prog
        if not self._arena.scope_ran(plan):
            return None
        if plan.chunked:
            prog = arena.ChunkedProgram(plan)
            self._arena.put(prog)
            return prog
        cols_list = [self._cols_for_segment(s, ds, plan.lowering.columns, m) for s in plan.segs]
        prog = arena.build_arena_program(self, plan, cols_list)
        self._arena.put(prog)
        if prog.graph is not None:
            m.graph_captures += 1
            m.capture_ms += prog.capture_ms
        return prog

    def _segment_loop(self, lowering: GroupByLowering, segs, ds: DataSource,
                      strategy: str, m: QueryMetrics):
        """The eager segment loop: a pass per segment, a checkpoint before
        each.  None when a deadline stopped it before the first."""
        pc = current_partial()
        state = None
        for i, seg in enumerate(segs):  # canonical segment order: the fold order
            if checkpoint_partial(arena.SEGMENT_LOOP_SITE):
                break
            cols = self._cols_for_segment(seg, ds, lowering.columns, m)
            fire("device_dispatch")
            with span(SPAN_SEGMENT_DISPATCH, segment=i), prof.device_timer(self.device):
                state = fold_partials(lowering.la, state, shard_partials(lowering, cols, strategy))
            m.dispatch_count += 1
            if pc is not None:
                pc.add_seen(1, *row_counts((seg,)))
        return state

    def _host_state(self, la: LoweredAggs, state):
        """A merged device state fetched to the host: (sums, mins, maxs,
        sketch states in the reference's layout, no slot gids).  Sums, mins
        and maxs come back in one copy, so one sync."""
        sums, mins, maxs, sketches = state
        parts = (sums, mins, maxs)
        prof.fetch_sync(self.device)
        flat = torch.cat([t.reshape(-1) for t in parts]).cpu().numpy()
        out, at = [], 0
        for t in parts:
            out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        return (*out, sketch_states_to_reference(la, sketches), None)

    def _execute_groupby(self, q: Q.GroupByQuery, ds: DataSource, strategy: Optional[str] = None):
        """One group-by under the retry policy (`run_device_attempts`):
        queries are read-only, so a re-dispatch after a transient failure is
        always safe.  An attempt lowers on the host, holds the execution
        lock across the device half and the fetch (a replay's outputs live
        in a pool the next replay reuses) and finalizes after releasing it;
        the backoff between attempts holds no lock.  Static errors and
        DeadlineExceeded propagate at once and never touch the breaker."""
        q = groupby_with_time_granularity(q)  # the key the eviction drops

        def attempt():
            scope = self._lower_scope(q, ds)
            with self._exec_lock:
                finish = self._dispatch_groupby_once(q, ds, scope, strategy)()
            return finish()

        return run_device_attempts(self, attempt, lambda: self.evict_query_state(q, ds))

    def evict_query_state(self, q: Q.GroupByQuery, ds: DataSource) -> None:
        """Drops what a failed dispatch may have poisoned: the query's
        lowerings (the adaptive tier's compacted ones too), its arena
        programs and warm marks, and the datasource's resident columns.
        The columns leave through the residency cache, whose `on_evict`
        drops every program that reads them, so a retry never replays a
        graph over freed memory."""
        with self._exec_lock:
            base = _query_key(q, ds)
            for k in [k for k in self._lowering_cache if k[:len(base)] == base]:
                self._lowering_cache.pop(k)
            self._arena.invalidate_query(base)
            uids = {seg.uid for seg in ds.segments}
            for k in [k for k in self._device_cache if k[0] in uids]:
                self._device_cache.pop(k)

    def execute_groupby_batch(self, queries, ds: DataSource, set_labels=None,
                              strategies=None) -> List:
        """Runs several group-bys (the sets of a CUBE or ROLLUP): every
        query is lowered, then every one's device work is dispatched, then
        each is fetched in order, so the card runs query i + 1 while the
        host waits on query i; dispatch and fetch under the execution lock,
        the lowering before it and the finalizing after it.  A
        transient failure of one query's dispatch or fetch evicts its state
        and runs it again alone, under the retry policy.  `set_labels`
        names each query's pass for the partial collector's per-set
        accounting; `strategies` each query's strategy (None: the
        engine's)."""
        pc = current_partial()
        strategies = list(strategies or [None] * len(queries))

        def label(i):
            if pc is not None and set_labels is not None:
                pc.set_label = set_labels[i]

        def failed(q, err, what):
            if not _retryable(err):
                raise err
            log.warning("batch %s failed (%s: %s); the query runs alone",
                        what, type(err).__name__, err)
            self.evict_query_state(groupby_with_time_granularity(q), ds)

        scopes = [self._lower_scope(q, ds) for q in queries]
        finishes = [None] * len(queries)
        with self._exec_lock:
            fetches = []
            for i, q in enumerate(queries):
                label(i)
                try:
                    fetches.append(self._dispatch_groupby_once(q, ds, scopes[i], strategies[i]))
                except RuntimeError as err:
                    failed(q, err, "dispatch")
                    fetches.append(None)
            for i, q in enumerate(queries):
                label(i)  # a tier's second pass counts under its set
                fetch, fetches[i] = fetches[i], None  # free its device state
                if fetch is not None:
                    try:
                        finishes[i] = fetch()
                    except RuntimeError as err:
                        failed(q, err, "fetch")
        out = []
        for i, q in enumerate(queries):
            label(i)
            out.append(finishes[i]() if finishes[i] is not None
                       else self._execute_groupby(q, ds, strategies[i]))
        return out

    # -- host partial states (the result cache's delta reuse) ----------------

    @contextlib.contextmanager
    def state_capture(self):
        """Captures the merged host partial state of the next group-by
        execution on this thread: yields a dict whose "state" holds it
        ({"sums", "mins", "maxs", "sketches"}, the reference's layout), or
        None when the execution took a path with no state over the query's
        own groups (the adaptive or sparse tier) or a deadline cut it (a
        partial state must never seed the cache)."""
        holder = {"state": None}
        self._capture_local.holder = holder
        try:
            yield holder
        finally:
            self._capture_local.holder = None

    def _capture_state(self, sums, mins, maxs, sketches) -> None:
        holder = getattr(self._capture_local, "holder", None)
        if holder is None:
            return
        pc = current_partial()
        if pc is not None and pc.triggered:
            return
        holder["state"] = {"sums": sums, "mins": mins, "maxs": maxs, "sketches": sketches}

    def set_residency_budget(self, nbytes: int) -> None:
        """Caps the device residency at `nbytes` (3/4 of the card by
        default), evicting past it at once: processes that share one card
        (a broker and its historicals, ranks on one card) each take a
        share."""
        self._device_cache.set_budget(nbytes)

    def groupby_partials_host(self, q: Q.QuerySpec, ds: DataSource, within_uids=None,
                              strategy: Optional[str] = None):
        """The merged host partial state of a GroupBy-family query over its
        in-scope segments whose uid is in `within_uids` (None: the whole
        scope), by the kernel strategy of its G under `strategy` (None: the
        engine's; no tier runs), through the arena (so a
        repeated refresh over one set of delta segments captures and then
        replays its graph).  The result cache's delta reuse calls it with
        the uids appended since a cached answer, so a refresh scans the
        deltas alone.  Returns (state, the QueryMetrics of the pass)."""
        inner, _ = self._groupby_family(q, ds)
        if inner is None:
            raise ValueError(f"{type(q).__name__} has no partial state")
        lower_ms, inner, lowering, segs = self._lower_scope(groupby_with_time_granularity(inner), ds)
        if within_uids is not None:
            within = frozenset(within_uids)
            segs = [s for s in segs if s.uid in within]
        t0 = time.perf_counter()
        G = lowering.num_groups
        m = QueryMetrics(
            query_type=_wire_type(q), strategy=self._resolve_strategy(G, strategy),
            datasource=ds.name,
            device=str(self.device), query_id=current_query_id(),
            rows_scanned=_row_count(segs), bytes_scanned=_bytes_scanned(segs, lowering.columns),
            segments=len(segs), num_groups=G,
        )
        with self._exec_lock:
            state = self._partials_for_query(lowering, segs, ds, m.strategy, m)
            with span(SPAN_DEVICE_FETCH):
                sums, mins, maxs, sketches, _ = self._host_state(lowering.la, state)
        m.total_ms = lower_ms + (time.perf_counter() - t0) * 1e3
        return {"sums": sums, "mins": mins, "maxs": maxs, "sketches": sketches}, m

    def merge_groupby_states(self, q: Q.QuerySpec, ds: DataSource, a, b):
        """Two host partial states of one query over one dictionary domain
        merged, `a` first: sums add, min/max fold, sketches merge by type
        through the ops the segment fold uses.  The states are host arrays
        and so is the merge: it runs on the CPU, outside the execution lock,
        and never touches the card, where another thread may be capturing
        a graph.  Raises ValueError on a shape mismatch (the domain
        changed)."""
        if a["sums"].shape != b["sums"].shape:
            raise ValueError(
                f"partial-state shape mismatch {a['sums'].shape} vs {b['sums'].shape} "
                "(dictionary domain changed)")
        inner, _ = self._groupby_family(q, ds)
        la = self._lowering_for(groupby_with_time_granularity(inner), ds).la
        sketches = {}
        for agg in la.sketch_aggs:
            ops = sketch_ops(agg)
            merged = ops.merge_states(ops.from_reference_state(a["sketches"][agg.name], "cpu"),
                                      ops.from_reference_state(b["sketches"][agg.name], "cpu"),
                                      agg)
            sketches[agg.name] = ops.to_reference_state(merged)
        return {
            "sums": a["sums"] + b["sums"],
            "mins": np.minimum(a["mins"], b["mins"]),
            "maxs": np.maximum(a["maxs"], b["maxs"]),
            "sketches": sketches,
        }

    def finalize_groupby_state(self, q: Q.QuerySpec, ds: DataSource, state):
        """A host partial state as the query's result frame: the finalize
        the execution path runs."""
        inner, shape = self._groupby_family(q, ds)
        inner = groupby_with_time_granularity(inner)
        lowering = self._lowering_for(inner, ds)
        with span(SPAN_FINALIZE):
            df = finalize_groupby(inner, lowering.dims, lowering.la, state["sums"],
                                  state["mins"], state["maxs"], state["sketches"])
        return shape(df)

    # -- micro-batch fusion (serve/) -----------------------------------------

    def _groupby_family(self, q: Q.QuerySpec, ds: DataSource):
        """A GroupBy-family query as its inner GroupBy and the shaper of its
        result type: (inner, shape), or (None, None) for other types."""
        if isinstance(q, Q.TimeseriesQuery):
            return timeseries_to_groupby(q), lambda df: finalize_timeseries(df, q, ds)
        if isinstance(q, Q.TopNQuery):
            return topn_to_groupby(q), lambda df: finalize_topn(df, q)
        if isinstance(q, Q.GroupByQuery):
            return q, lambda df: df
        return None, None

    def fusable(self, q: Q.QuerySpec, ds: DataSource, strategy: Optional[str] = None) -> bool:
        """May this query join a fused micro-batch under `strategy` (None:
        the engine's)?  GroupBy-family only (mergeable partial state), no
        wire subtotals, and neither the adaptive nor the sparse tier would
        engage (their passes read counts on the host between dispatches)."""
        inner, _ = self._groupby_family(q, ds)
        if inner is None or inner.subtotals:
            return False
        try:
            lowering = self._lowering_for(groupby_with_time_granularity(inner), ds)
        except Exception:  # an unlowerable query declines fusion
            return False
        return not (self._adaptive_eligible(lowering, strategy)
                    or self._sparse_eligible(lowering, strategy))

    def execute_fused(self, queries, ds: DataSource, query_ids=None, strategies=None):
        """Runs N fusable queries over one datasource snapshot as one
        execution, with the warm rule of a scope (`exec/arena.py`): a
        member set's first batch runs the fused eager loop (each segment's
        columns read once, every member that scopes it folding there), its
        second captures one CUDA graph over the resident segments, later
        ones replay it; the graph's output packs every member's (sums,
        mins, maxs) and comes back in one copy.  Sketch members and scopes
        the arena declines always run the fused eager loop.  Either way
        each member's fold is its serial fold, so its frame is
        bit-identical to `execute`'s under its strategy (`strategies`, one
        per member: a member keeps its own plan; None: the engine's).  A
        deadline that expires first
        (`engine.fused_loop`) raises: the fusion scheduler then sends every
        member to its serial path.  Returns a list of (df, state, metrics)
        per member, in order; `state` is the member's merged host partial
        state (the result cache keeps it for delta reuse).  The device half
        and the fetch run under the execution lock, the finalizing after
        it."""
        t0 = time.perf_counter()
        queries = list(queries)
        n = len(queries)
        prof.note_fusion(n)  # the leader's receipt records the batch size
        query_ids = list(query_ids or [""] * n)
        members = []
        with span(SPAN_LOWER, fused=n):
            for q in queries:
                inner, shape = self._groupby_family(q, ds)
                if inner is None:
                    raise ValueError(
                        f"{type(q).__name__} is not fusable (GroupBy-family queries only)")
                inner = groupby_with_time_granularity(inner)
                lowering = self._lowering_for(inner, ds)
                members.append((q, inner, shape, lowering, segments_in_scope(inner, ds)))
        asked = list(strategies or [None] * n)
        strategies = tuple(self._resolve_strategy(mb[3].num_groups, s)
                           for mb, s in zip(members, asked))
        bm = QueryMetrics(query_type="fused", device=str(self.device))
        # the card's share under the execution lock; finalizing runs after
        with self._exec_lock:
            host, sketches = self._fused_device(members, strategies, ds, bm)
        out = []
        at = 0
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        for i, (q, inner, shape, lowering, msegs) in enumerate(members):
            la, G = lowering.la, lowering.num_groups
            states = []
            for w in (len(la.sum_names), len(la.min_names), len(la.max_names)):
                # an owned copy: a cached state must not keep the whole
                # batch's packed buffer alive
                states.append(host[at:at + G * w].reshape(G, w).copy())
                at += G * w
            with span(SPAN_FINALIZE, member=i):
                df = shape(finalize_groupby(inner, lowering.dims, la, *states, sketches[i]))
            m = QueryMetrics(
                query_type=_wire_type(q),
                strategy=strategies[i],
                datasource=ds.name,
                device=str(self.device),
                query_id=query_ids[i],
                rows_scanned=_row_count(msegs),
                bytes_scanned=_bytes_scanned(msegs, lowering.columns),
                segments=len(msegs),
                num_groups=G,
                # the batch's h2d and capture, split evenly: one column set
                # moved for every member
                h2d_bytes=bm.h2d_bytes // n,
                h2d_ms=bm.h2d_ms / n,
                capture_ms=bm.capture_ms,
                graph_captures=bm.graph_captures,
                graph_replays=bm.graph_replays,
                dispatch_count=bm.dispatch_count,
                arena_segments=bm.arena_segments,
                declines=list(bm.declines),
                total_ms=elapsed_ms,
                fused_batch=n,
                bytes_resident=self.bytes_resident(),
            )
            record_query_metrics(m, "ok")
            out.append((df, {"sums": states[0], "mins": states[1], "maxs": states[2],
                             "sketches": sketches[i]}, m))
        self.last_metrics = out[-1][2] if out else None
        return out

    def _fused_device(self, members, strategies, ds, bm):
        """The device half of a fused batch (under the execution lock): the
        packed (sums, mins, maxs) of every member on the host and each
        member's sketch states in the reference's layout, from the fused
        graph or the fused eager loop (at a member set's first batch, which
        marks the set warm, or where the arena declines)."""
        n = len(members)
        lowerings = [mb[3] for mb in members]
        in_scope = {s.uid for mb in members for s in mb[4]}
        segs = [s for s in ds.segments if s.uid in in_scope]
        names = list(dict.fromkeys(c for lw in lowerings for c in lw.columns))
        checkpoint("engine.fused_loop")
        plan = arena.fused_plan_for(self, lowerings, strategies, [mb[4] for mb in members],
                                    [mb[1] for mb in members], segs, names, ds, bm)
        prog = self._fused_program(plan, ds, bm) if plan is not None else None
        if prog is not None:
            fire("device_dispatch")
            with span(SPAN_SEGMENT_DISPATCH, arena=len(segs), fused=n), \
                    prof.device_timer(self.device):
                flat = prog.run()
            bm.dispatch_count += 1
            bm.arena_segments += len(segs)
            bm.graph_replays += prog.graph is not None
            with span(SPAN_DEVICE_FETCH, fused=n):
                prof.fetch_sync(self.device)
                host = flat.cpu().numpy()
            return host, [{} for _ in members]
        host, sketches = self._fused_loop(members, strategies, segs, names, ds, bm)
        if plan is not None:
            self._arena.note_warm(plan)
        return host, [sketch_states_to_reference(mb[3].la, sk)
                      for mb, sk in zip(members, sketches)]

    def _fused_program(self, plan: "arena.FusedPlan", ds: DataSource, m: QueryMetrics):
        """The fused batch's program from the arena cache; captured (on a
        card) at the member set's second batch; None at its first, which
        runs the fused eager loop."""
        prog = self._arena.get(plan.key)
        prof.note_program_cache("arena-fused", hit=prog is not None)
        if prog is not None:
            self._device_cache.touch(plan.col_keys)
            return prog
        if not self._arena.scope_ran(plan):
            return None
        cols = {s.uid: self._cols_for_segment(s, ds, plan.names, m) for s in plan.segs}
        prog = arena.build_fused_program(self, plan, cols)
        self._arena.put(prog)
        if prog.graph is not None:
            m.graph_captures += 1
            m.capture_ms += prog.capture_ms
        return prog

    def _fused_loop(self, members, strategies, segs, names, ds, m):
        """The fused eager loop: the union segments in canonical order, a
        checkpoint (`engine.fused_loop`) before each, its columns read
        once, every member that scopes it folding its partials there.
        Returns (the packed (sums, mins, maxs) of every member on the
        host, fetched in one copy, and each member's sketch states on the
        host)."""
        from ..serve.fusion import shared_row_plan

        prof.note_program_cache("fused-batch", hit=False)
        share = shared_row_plan([mb[1] for mb in members])
        in_scope = [frozenset(s.uid for s in mb[4]) for mb in members]
        acc = [None] * len(members)
        for seg in segs:
            checkpoint("engine.fused_loop")
            cols = self._cols_for_segment(seg, ds, names, m)
            fire("device_dispatch")
            with span(SPAN_SEGMENT_DISPATCH, segment=seg.uid, fused=len(members)), \
                    prof.device_timer(self.device):
                memo: Dict = {}
                for i, mb in enumerate(members):
                    if seg.uid in in_scope[i]:
                        part = shard_partials(mb[3], cols, strategies[i], memo=memo,
                                              share=share[i])
                        acc[i] = fold_partials(mb[3].la, acc[i], part)
            m.dispatch_count += 1
        parts, sketches = [], []
        for i, mb in enumerate(members):
            lw = mb[3]
            st = acc[i] if acc[i] is not None else empty_partials(
                lw.la, lw.num_groups, self.device)
            parts.extend(t.reshape(-1) for t in st[:3])
            sketches.append(st[3])
        with span(SPAN_DEVICE_FETCH, fused=len(members)):
            prof.fetch_sync(self.device)
            host = torch.cat(parts).cpu().numpy()
        return host, sketches

    def _lower_scope(self, q: Q.GroupByQuery, ds: DataSource):
        """The host work before a group-by's device half, in the `lower`
        span: (its ms, the query at its time granularity, its lowering,
        its segments in scope)."""
        t0 = time.perf_counter()
        with span(SPAN_LOWER):
            q = groupby_with_time_granularity(q)
            lowering, segs = self._lowering_for(q, ds), segments_in_scope(q, ds)
        return (time.perf_counter() - t0) * 1e3, q, lowering, segs

    def _dispatch_groupby_once(self, q: Q.GroupByQuery, ds: DataSource, scope,
                               strategy: Optional[str] = None):
        """The device half of one group-by under `strategy` (None: the
        engine's), under the caller's hold of the execution lock: the tiers
        and the segment work, up to the merged
        state on the device (the sparse tier fetches as it climbs its
        ladders).  `scope` is `_lower_scope(q, ds)`, made before the lock
        was taken.  Returns `fetch() -> finish`: the fetch, under the same
        hold, and `finish() -> df`, the finalization and the metrics, on
        the host after the lock is released."""
        lower_ms, q, lowering, segs = scope
        t_total = time.perf_counter()
        G = lowering.num_groups
        m = QueryMetrics(
            query_type="groupBy",
            strategy=self._resolve_strategy(G, strategy),
            datasource=ds.name,
            device=str(self.device),
            query_id=current_query_id(),
            rows_scanned=sum(s.num_rows for s in segs),
            bytes_scanned=_bytes_scanned(segs, lowering.columns),
            segments=len(segs),
            num_groups=G,
        )
        t_dev = time.perf_counter()
        try:
            low, state, host = self._dispatch_tiers(q, ds, lowering, segs, m, strategy)
        except BaseException as err:
            # the failed attempt's metrics stand: the retry policy and the
            # API stamp them
            m.deadline_exceeded = isinstance(err, DeadlineExceeded)
            m.total_ms = lower_ms + (time.perf_counter() - t_total) * 1e3
            self._finish_metrics(m, "deadline" if m.deadline_exceeded else "error")
            raise
        t_end = time.perf_counter()
        dispatch_dev_ms = (t_end - t_dev) * 1e3
        # the query's own time: lowering, the device half, its fetch and
        # its finalizing (not the wait for the lock; a batch runs its other
        # queries in between)
        spent = [lower_ms + (t_end - t_total) * 1e3]

        def done(outcome: str, since: float) -> None:
            m.total_ms = spent[0] + (time.perf_counter() - since) * 1e3
            self._finish_metrics(m, outcome)

        def fetch():
            t_fetch = time.perf_counter()
            try:
                # a deadline blown during dispatch cancels before the fetch;
                # under a collector every segment is already dispatched, so
                # the fetch drains a complete answer
                checkpoint_partial("engine.resolve")
                with span(SPAN_DEVICE_FETCH):
                    sums, mins, maxs, sketches, slot_gids = (
                        host if host is not None else self._host_state(low.la, state))
                if host is None and low is lowering:
                    # a state over the query's own groups (no tier's)
                    self._capture_state(sums, mins, maxs, sketches)
            except BaseException as err:
                m.deadline_exceeded = isinstance(err, DeadlineExceeded)
                done("deadline" if m.deadline_exceeded else "error", t_fetch)
                raise
            fetch_ms = (time.perf_counter() - t_fetch) * 1e3
            spent[0] += fetch_ms
            m.device_ms = dispatch_dev_ms + fetch_ms - m.h2d_ms

            def finish():
                t0 = time.perf_counter()
                outcome = "error"
                try:
                    with span(SPAN_FINALIZE):
                        df = finalize_groupby(
                            q, low.dims, low.la, sums, mins, maxs, sketches, slot_gids=slot_gids
                        )
                    m.finalize_ms = (time.perf_counter() - t0) * 1e3
                    outcome = "ok"
                finally:
                    done(outcome, t0)
                return df

            return finish

        return fetch

    def _finish_metrics(self, m: QueryMetrics, outcome: str = "ok") -> None:
        """Publishes an execution's metrics as `last_metrics`, stamped
        partial with its coverage when the collector says the answer is,
        and into the process metrics registry."""
        m.bytes_resident = self.bytes_resident()
        m.query_id = m.query_id or current_query_id()
        pc = current_partial()
        if pc is not None and pc.is_partial:
            m.partial = True
            m.coverage = pc.coverage()
            m.rows_seen = pc.rows_seen
            m.delta_rows_seen = pc.delta_rows_seen
        self.last_metrics = m
        record_query_metrics(m, "partial" if outcome == "ok" and m.partial else outcome)

    def _dispatch_tiers(self, q, ds: DataSource, lowering: GroupByLowering, segs,
                        m: QueryMetrics, strategy: Optional[str] = None):
        """The tiers `strategy` makes eligible, in order, then its kernel
        strategy: (the lowering that answered, its merged device state or
        None, the sparse tier's host state or None)."""
        G = lowering.num_groups
        qkey = memo_key(q, ds)
        low, state, host = lowering, None, None
        if segs and self._adaptive_eligible(lowering, strategy):
            if qkey in self._adaptive_declined:
                m.declines.append(self._adaptive_declined[qkey])
            else:
                out = self._groupby_adaptive(q, ds, lowering, segs, m)
                if out is not None:
                    m.strategy = "adaptive"
                    low, state = out
        if state is None and segs and self._sparse_eligible(lowering, strategy):
            if qkey in self._sparse_disabled:
                m.declines.append(self._sparse_disabled[qkey])
            else:
                out = self._groupby_sparse(q, ds, lowering, segs, m)
                if out is not None:
                    m.strategy = "sparse"
                    m.declines.append(
                        "arena: the sparse tier answered (its ladders read counts per pass)")
                    low, host = out[0], out[1:]
        if state is None and host is None:
            m.strategy = self._resolve_strategy(G, strategy)
            state = self._partials_for_query(lowering, segs, ds, m.strategy, m)
        return low, state, host

    # -- progressive execution -----------------------------------------------

    def execute_progressive(self, q: Q.QuerySpec, ds: DataSource,
                            strategy: Optional[str] = None):
        """Refinements of one aggregate query: after each in-scope segment
        the running state is fetched and finalized, yielding `(df, info)`
        with `info` = {"sequence", "coverage", "rows_seen", "rows_total",
        "segments_seen", "segments_total", "final", "partial"}.  The last
        refinement is the exact answer, bit-identical to `execute`'s frame
        under `strategy` (the same kernel strategy, the same fold order;
        None: the engine's), unless a deadline
        stops the loop: the last one is then the partial answer, flagged
        `partial`.  It runs the eager loop (each refinement fetches, so
        there is nothing to capture) and none of the high-cardinality
        tiers.  Other query types execute once and yield once."""
        if isinstance(q, Q.TimeseriesQuery):
            inner = timeseries_to_groupby(q)

            def shape(df):
                return finalize_timeseries(df, q, ds)
        elif isinstance(q, Q.TopNQuery):
            inner = topn_to_groupby(q)

            def shape(df):
                return finalize_topn(df, q)
        elif isinstance(q, Q.GroupByQuery):
            inner = q

            def shape(df):
                return df
        else:
            df = self.execute(q, ds)
            info = {"sequence": 0, "coverage": 1.0, "final": True, "partial": False}
            pc = current_partial()
            if pc is not None and pc.is_partial:
                d = pc.to_dict()
                info.update(partial=True, coverage=d["coverage"], rows_seen=d["rows_seen"],
                            rows_total=d["rows_total"])
            yield df, info
            return
        t0 = time.perf_counter()
        inner = groupby_with_time_granularity(inner)
        lowering = self._lowering_for(inner, ds)
        segs = segments_in_scope(inner, ds)
        la, G = lowering.la, lowering.num_groups
        strategy = self._resolve_strategy(G, strategy)
        rows_total = _row_count(segs)
        m = QueryMetrics(
            query_type="progressive", strategy=strategy, datasource=ds.name,
            device=str(self.device), rows_scanned=rows_total,
            bytes_scanned=_bytes_scanned(segs, lowering.columns), segments=len(segs),
            num_groups=G,
            declines=["arena: progressive (each refinement fetches; nothing to capture)"],
        )
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))

        def refinement(state):
            sums, mins, maxs, sketches, _ = self._host_state(la, state)
            return shape(finalize_groupby(inner, lowering.dims, la, sums, mins, maxs, sketches))

        state = None
        rows_seen = seq = 0
        truncated = False
        try:
            for i, seg in enumerate(segs):
                # the lock is held for a segment's work and its refinement,
                # never across a yield (the consumer may be a slow client)
                with self._exec_lock:
                    if checkpoint_partial("engine.progressive_loop"):
                        truncated = True
                        break
                    cols = self._cols_for_segment(seg, ds, lowering.columns, m)
                    fire("device_dispatch")
                    with span(SPAN_SEGMENT_DISPATCH, segment=i), prof.device_timer(self.device):
                        state = fold_partials(la, state, shard_partials(lowering, cols, strategy))
                    m.dispatch_count += 1
                    rows_seen += seg.num_rows
                    if pc is not None:
                        pc.add_seen(1, *row_counts((seg,)))
                    df = refinement(state)
                yield df, {
                    "sequence": seq,
                    "coverage": rows_seen / rows_total if rows_total else 1.0,
                    "rows_seen": rows_seen,
                    "rows_total": rows_total,
                    "segments_seen": i + 1,
                    "segments_total": len(segs),
                    "final": i + 1 == len(segs),
                    "partial": False,
                }
                seq += 1
            if state is None or truncated:
                # an empty scope, or a deadline cut the scan short: the
                # merged state so far is the final answer, with its coverage
                with self._exec_lock:
                    if state is None:
                        state = empty_partials(la, G, self.device)
                    df = refinement(state)
                yield df, {
                    "sequence": seq,
                    "coverage": rows_seen / rows_total if rows_total else (
                        None if truncated else 1.0),
                    "rows_seen": rows_seen,
                    "rows_total": rows_total,
                    "segments_seen": m.dispatch_count,
                    "segments_total": len(segs),
                    "final": True,
                    "partial": truncated,
                }
        finally:
            m.total_ms = (time.perf_counter() - t0) * 1e3
            self._finish_metrics(m)

    # -- scan ----------------------------------------------------------------

    def _execute_scan(self, q: Q.ScanQuery, ds: DataSource):
        import pandas as pd

        t_total = time.perf_counter()
        filter_fn = compile_filter(q.filter, ds) if q.filter is not None else None
        vcol_fns = {v.name: _decoded_expr_fn(v.expression, ds) for v in q.virtual_columns}
        order_cols = [c.dimension for c in q.order_by]
        if "__time" in order_cols and not ds.time_column:
            # the legacy wire `order` implies time ordering, which a
            # timeless table cannot honour
            raise Q.QueryValidationError(
                f"scan ordering by __time: datasource {ds.name!r} has no time column")
        sortable = set(q.columns) | {c.name for c in ds.columns} | set(vcol_fns) | {"__time"}
        for c in order_cols:
            # wire queries arrive unplanned: a bad orderBy is the client's
            if c not in sortable:
                raise Q.QueryValidationError(f"scan orderBy unknown column {c!r}")
        fetch_list = list(dict.fromkeys(list(q.columns) + order_cols))
        need = [c for c in fetch_list if c not in vcol_fns and c != "__time"]
        if q.filter is not None:
            need += [c for c in _filter_columns(q.filter) if c != "__time"]
        for v in q.virtual_columns:
            need += [c for c in v.expression.columns() if c != "__time"]
        if ds.time_column:
            need.append(ds.time_column)
        need = list(dict.fromkeys(need))
        # an unordered scan stops once it holds limit + offset rows; an
        # ordered one must see every segment
        remaining = None if q.order_by else (
            q.limit + q.offset if q.limit is not None else None)
        top = q.limit + q.offset if q.order_by and q.limit is not None else None
        presort = bool(top) and _presortable(q.order_by[0], ds, vcol_fns)
        segs = segments_in_scope(q, ds)
        m = QueryMetrics(query_type="scan", strategy="scan", datasource=ds.name,
                         device=str(self.device))
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))
        frames = []
        for seg in segs:  # canonical segment order: the row order
            # past its deadline a scan answers with the rows fetched so far
            if checkpoint_partial("engine.scan_loop"):
                break
            with self._exec_lock:  # a segment's device work and its copy back
                cols = self._cols_for_segment(seg, ds, need, m)
                for name, fn in vcol_fns.items():
                    cols[name] = as_tensor(fn(cols), cols["__valid"])
                mask = row_mask(cols, q.intervals, filter_fn)
                idx = torch.nonzero(mask).squeeze(1)
                if remaining is not None:
                    idx = idx[:remaining]
                elif presort and idx.numel() > top:
                    idx = _top_candidates(cols, q.order_by[0], idx, top)
                fetched, nbytes = _fetch_rows(cols, fetch_list, idx)
                del cols, mask, idx
            m.d2h_bytes += nbytes
            data = {}
            for c in fetch_list:
                arr = fetched[c]
                if c in ds.dicts:
                    arr = ds.dicts[c].decode(arr)
                data[c] = arr
            f = pd.DataFrame(data)
            if remaining is not None:
                remaining -= len(f)
            elif top is not None:
                # ordered + limited: only each segment's top limit + offset
                # rows can reach the result
                f = apply_limit_spec(f, Q.LimitSpec(top, q.order_by, 0))
            frames.append(f)
            m.segments += 1
            m.rows_scanned += seg.num_rows
            m.dispatch_count += 1
            if pc is not None:
                pc.add_seen(1, *row_counts((seg,)))
            if remaining is not None and remaining <= 0:
                break
        out = (pd.concat(frames, ignore_index=True) if frames
               else pd.DataFrame(columns=fetch_list))
        out = apply_limit_spec(out, Q.LimitSpec(q.limit, q.order_by, q.offset))
        m.total_ms = (time.perf_counter() - t_total) * 1e3
        self._finish_metrics(m)
        return out[list(q.columns)].reset_index(drop=True)

    # -- search --------------------------------------------------------------

    def _execute_search(self, q: Q.SearchQuery, ds: DataSource):
        """Dimension-value search: the candidate values come from the host
        dictionaries, and each carries its count of matching rows (Druid's
        search response), counted per code on the device over the rows in
        scope (intervals, zone maps, filter); values with no matching row
        are left out."""
        import pandas as pd

        t_total = time.perf_counter()
        # candidate codes from the host dictionaries first: a needle that
        # matches nothing costs no scan
        needle = q.query.lower()
        matching = {
            dim: [code for code, v in enumerate(ds.dicts[dim].values)
                  if needle in str(v).lower()]
            for dim in q.dimensions
        }
        live_dims = [d for d in q.dimensions if matching[d]]
        m = QueryMetrics(query_type="search", strategy="search", datasource=ds.name,
                         device=str(self.device))
        if not live_dims:
            self.last_metrics = m
            return pd.DataFrame(columns=["dimension", "value", "count"])
        segs = segments_in_scope(q, ds)
        filter_fn = compile_filter(q.filter, ds) if q.filter is not None else None
        names = live_dims + (_filter_columns(q.filter) if filter_fn is not None else [])
        if ds.time_column and (q.intervals or "__time" in names):
            names.append(ds.time_column)
        names = list(dict.fromkeys(n for n in names if n != "__time"))
        # one count per code and a last bin that takes masked and null rows;
        # the device work takes the execution lock a segment at a time
        with self._exec_lock:
            counts = {dim: torch.zeros(ds.dicts[dim].cardinality + 1, dtype=torch.int64,
                                       device=self.device) for dim in live_dims}
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))
        for seg in segs:
            # the counts over the segments seen so far are a sound answer
            if checkpoint_partial("engine.search_loop"):
                break
            with self._exec_lock:
                cols = self._cols_for_segment(seg, ds, names, m)
                # a timeless table has no time to scope
                mask = row_mask(cols, q.intervals if ds.time_column else (), filter_fn)
                for dim in live_dims:
                    c = counts[dim]
                    codes = cols[dim].to(torch.int64)
                    slot = torch.where(mask & (codes >= 0), codes, c.numel() - 1)
                    c += torch.bincount(slot, minlength=c.numel())
                del cols, mask
            m.segments += 1
            m.rows_scanned += seg.num_rows
            m.dispatch_count += 1
            if pc is not None:
                pc.add_seen(1, *row_counts((seg,)))
        with self._exec_lock:
            host = {dim: c.cpu().numpy() for dim, c in counts.items()}
            del counts
        rows = []
        for dim in live_dims:
            if len(rows) >= q.limit:
                break
            d = ds.dicts[dim]
            for code in matching[dim]:
                if host[dim][code] > 0:
                    rows.append({"dimension": dim, "value": d.values[code],
                                 "count": int(host[dim][code])})
                    if len(rows) >= q.limit:
                        break
        m.total_ms = (time.perf_counter() - t_total) * 1e3
        self._finish_metrics(m)
        return pd.DataFrame(rows, columns=["dimension", "value", "count"])

    # -- metadata queries: catalog reads, no device work ----------------------

    def _execute_time_boundary(self, q: Q.TimeBoundaryQuery, ds: DataSource):
        """Druid `timeBoundary`, from segment metadata."""
        import pandas as pd

        iv = ds.interval()
        if iv is None:
            return pd.DataFrame(columns=["minTime", "maxTime"])
        lo, hi = iv
        row = {}
        if q.bound in (None, "minTime"):
            row["minTime"] = np.datetime64(int(lo), "ms")
        if q.bound in (None, "maxTime"):
            row["maxTime"] = np.datetime64(int(hi), "ms")
        return pd.DataFrame([row])

    def _execute_datasource_metadata(self, q: Q.DataSourceMetadataQuery, ds: DataSource):
        """Druid `dataSourceMetadata`: the newest ingested event time, from
        segment metadata."""
        import pandas as pd

        iv = ds.interval()
        if iv is None:
            return pd.DataFrame(columns=["maxIngestedEventTime"])
        return pd.DataFrame([{"maxIngestedEventTime": np.datetime64(int(iv[1]), "ms")}])

    def _execute_segment_metadata(self, q: Q.SegmentMetadataQuery, ds: DataSource):
        """Druid `segmentMetadata`: the catalog rendered per in-scope
        segment."""
        import pandas as pd

        # the schema is the datasource's: one columns dict shared by all
        cols = {c.name: {"type": c.kind, "dtype": c.dtype, "cardinality": c.cardinality}
                for c in ds.columns}
        rows = [
            {
                "id": seg.segment_id,
                "intervals": (
                    [f"{_ms_to_iso(int(seg.interval[0]))}/{_ms_to_iso(int(seg.interval[1]))}"]
                    if seg.interval is not None else []),
                "numRows": seg.num_rows,
                "columns": cols,
            }
            for seg in segments_in_scope(q, ds)
        ]
        return pd.DataFrame(rows, columns=["id", "intervals", "numRows", "columns"])


def _presortable(key: Q.OrderByColumnSpec, ds: DataSource, vcol_fns) -> bool:
    """Whether an ordered scan's first sort key can preselect a segment's
    candidate rows on the device: a numeric column whose values order as
    the host sort orders them (the time column, a metric, a virtual
    column), not dictionary codes."""
    return key.dimension in vcol_fns or key.dimension == "__time" or (
        key.dimension not in ds.dicts
        and any(c.name == key.dimension and c.kind != "dimension" for c in ds.columns))


def _top_candidates(cols, key: Q.OrderByColumnSpec, idx: torch.Tensor, k: int):
    """The rows of `idx` that can be among the first `k` under a stable
    sort by `key` (nulls last): every row whose key is at least as good as
    the k-th best.  Ties at the cut all stay, so the host's sort of the
    candidates picks the same rows, in the same order, as a sort of all of
    `idx`.  NaN ranks after every number, as the host sort places nulls."""
    v = cols[key.dimension].index_select(0, idx).to(torch.float64)
    if key.direction == "descending":
        v = -v
    v = torch.nan_to_num(v, nan=float("inf"))
    kth = torch.kthvalue(v, k).values
    return idx[v <= kth]


def _fetch_rows(cols, names, idx: torch.Tensor):
    """The rows `idx` of each named column, gathered on the device into one
    byte buffer and copied to the host in one transfer.  Columns pack
    widest first, so each column's slice of the host buffer is aligned for
    its dtype.  Returns (name -> host array, bytes copied)."""
    picked = {n: cols[n].index_select(0, idx) for n in names}
    order = sorted(picked, key=lambda n: -picked[n].element_size())
    buf = torch.cat([picked[n].contiguous().view(torch.uint8).reshape(-1) for n in order])
    host = buf.cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    at = 0
    for n in order:
        t = picked[n]
        nbytes = t.numel() * t.element_size()
        out[n] = host[at:at + nbytes].view(torch.empty((), dtype=t.dtype).numpy().dtype)
        at += nbytes
    return out, int(host.nbytes)
