"""Multi-device group-by execution: row shards on every device of a mesh,
per-shard kernels, and the merge of their partial states.

The reference rebuilds Druid's broker scatter-gather on XLA collectives: the
historicals become mesh devices holding row shards, the fan-out a
`shard_map` over the ``data`` axis, the broker's merge `psum`/`pmin`/`pmax`
and an all-gather fold for sketches.  The port keeps one controller: this
process drives every device of the mesh (`parallel/mesh.py`), launches each
shard's work on its device before it reads any result back (so the cards
run at once), and merges by the mesh's one merge path (a fold per device in
shard order, NCCL across distinct cards).

**The per-shard kernel.**  The kernel class comes from the same cost model
as the single-device plan (`plan.cost.choose_query_kernel`), with this
engine's decline memos.  On a card the dense class is the hand-written
kernel (`ops/cuda_groupby`) at the per-device group count (`_groups_split`),
the scatter above SCATTER_CUTOVER; on the CPU its plain version.  A
shard is launched over in blocks of at most SHARD_BLOCK_ROWS rows, a
segment's, so no launch meets chunk counts the single device never
launches at.  Every rung runs on the mesh:

* dense and segment: each shard's dense [Gl, M] state, merged by sum, min
  and max (`_execute_dense_state`), or, where the arena applies, the
  stacked layout of `parallel/spmd_arena.py` with one CUDA graph per device
  (`_execute_arena`);
* sparse: each shard compacts its rows to slots
  (`ops.sparse_groupby.sparse_partial_aggregate`, the slots and row
  capacity ladders included), the states are all-gathered and folded with
  `merge_sparse_states` in shard order (`_execute_sparse`);
* adaptive: per-dimension presence counts on every shard, summed across
  shards, then the dense-state pass over the compacted lowering
  (`_execute_adaptive`).

The ``groups`` axis shards the group domain: the shard at (d, g) keeps only
the groups of [g Gl, (g + 1) Gl) from data shard d's rows.

**Shard residency.**  Row shards are keyed by (datasource, column, data-axis
size, the scope's full segment signature, device) in a `ByteBudgetCache`,
never by a query's filter, so a scope's placement is paid once; the arena's
stacks are keyed by the full segment signature alone.  The fault site
`h2d` fires before each placement.

**Processes.**  A mesh from `multihost.hybrid_mesh` spans processes: this
rank holds a contiguous run of the data axis (its slice), builds and places
only those positions' rows (`multihost.local_rows`; the arena stacks only
its own row devices' blocks), computes only their states, and merges them
with the other ranks' through `parallel/mesh`'s step across processes, in
rank order: the hierarchical tree, so a P x D run equals the one-process
P-slice x D slice mesh under that tree bit for bit.  Every rank decides
the same route (the cost model, and ladders read from merged states), so
their collectives pair up; deadline chunking stays in one process.

**Resilience.**  `execute` runs under `resilience.run_device_attempts`: a
transient failure evicts the query's lowering and programs and the
datasource's shards, and runs again, each outcome reported to the engine's
breaker (a context gives it its own "mesh" breaker).  `mesh.dispatch` is a
checkpoint before any device work; under an armed deadline the arena runs a
step at a time with the checkpoint `mesh.segment_loop` before each step, so
a partial answer covers whole blocks, its coverage counted on the host.

**Serving.**  `state_capture`, `groupby_partials_host`,
`merge_groupby_states` and `finalize_groupby_state` give the result cache's
delta reuse the same surface as `exec.engine.Engine`; `fusable` and
`execute_fused` run a micro-batch as one arena dispatch per device, every
member's fold inside it.

The device half of an execution runs under `_exec_lock`, as the
single-device engine's does: graphs share memory pools, and a capture may
not meet another thread's work on its device.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..catalog.segment import ROW_PAD, DataSource, row_counts
from ..config import SessionConfig
from ..models import aggregations as A
from ..models import query as Q
from ..obs import (
    SPAN_ADAPTIVE_PROBE,
    SPAN_ARENA_BUILD,
    SPAN_COLLECTIVE_MERGE,
    SPAN_FINALIZE,
    SPAN_SEGMENT_DISPATCH,
    SPAN_SPARSE_DISPATCH,
    current_query_id,
    prof,
    record_query_metrics,
    span,
    span_event,
)
from ..ops import cuda_groupby
from ..ops import sparse_groupby as sg
from ..ops.groupby import SCATTER_CUTOVER, partial_aggregate
from ..ops.quantiles import SEGMENT_POSITION
from ..resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    checkpoint,
    checkpoint_partial,
    current_deadline,
    current_partial,
    fire,
    run_device_attempts,
    site_armed,
)
from ..utils.log import get_logger
from ..utils.lru import ByteBudgetCache, CountBudgetCache
from . import multihost, spmd_arena
from .mesh import (
    DATA_AXIS,
    GROUPS_AXIS,
    SLICE_AXIS,
    Mesh,
    gather_states,
    make_mesh,
    merge_tree,
    reduce_states,
)

log = get_logger("parallel.distributed")

STRATEGIES = ("auto", "dense", "cuda", "segment", "scatter", "sparse", "adaptive")
# the checkpoint of the arena's step loop under a deadline
SEGMENT_LOOP_SITE = "mesh.segment_loop"
# row shards resident at once: this share of the first device's memory
SHARD_BUDGET_FRACTION = 0.25
PROGRAM_ENTRIES = 128
_SPARSE_STATE_KEYS = ("gids", "sums", "mins", "maxs")
_SPARSE_FLAG_KEYS = ("overflow", "row_overflow", "n_rows", "n_real")


# the most rows one launch takes on the row-shard path: a canonical
# segment's (`SessionConfig.compaction_rows_per_segment`), the most any
# launch of the single-device path takes, so the kernel runs at the chunk
# counts it runs at there.  A longer shard runs block by block, each
# block's state folded in row order, as the single device folds segments.
SHARD_BLOCK_ROWS = 1 << 19


def _row_blocks(rows: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each block of a shard of `rows` rows (one empty block for
    an empty shard)."""
    return [(lo, min(lo + SHARD_BLOCK_ROWS, rows))
            for lo in range(0, max(rows, 1), SHARD_BLOCK_ROWS)]


def _blocked_partial_aggregate(gid, mask, sv, mmv, mmm, **kw):
    """`partial_aggregate` over a shard, a launch per block of at most
    SHARD_BLOCK_ROWS rows, the states folded in row order."""
    acc = None
    for lo, hi in _row_blocks(gid.shape[0]):
        s, mn, mx = partial_aggregate(gid[lo:hi], mask[lo:hi], sv[lo:hi], mmv[lo:hi],
                                      mmm[lo:hi], **kw)
        acc = (s, mn, mx) if acc is None else (
            acc[0] + s, torch.minimum(acc[1], mn), torch.maximum(acc[2], mx))
    return acc


def _budget(device: torch.device) -> int:
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * SHARD_BUDGET_FRACTION)
    import os

    return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") * SHARD_BUDGET_FRACTION)


class _DeviceRef:
    """What `exec/arena`'s capture reads of an engine: the device, and the
    side stream graphs are captured on (one per device)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


class ShardProgram:
    """One device's share of a scope: its body, the membership buffer it
    reads, and on a card the CUDA graph of the body with its outputs and
    the kernel launches it captured.  On the CPU (or for the scatter, whose
    `nonzero` cannot be captured) the body runs eagerly."""

    __slots__ = ("device", "body", "memb", "graph", "outputs", "launches", "capture_ms")

    def __init__(self, device, body, memb, graph=None, outputs=None, launches=(),
                 capture_ms=0.0):
        self.device = device
        self.body = body
        self.memb = memb
        self.graph = graph
        self.outputs = outputs
        self.launches = tuple(launches)
        self.capture_ms = capture_ms

    def run(self, memb_host: Optional[np.ndarray] = None) -> List[torch.Tensor]:
        """The body's outputs, after the membership buffer took
        `memb_host`: a replay (its outputs copied out, the next replay
        overwrites them, and its launches counted) or the body itself."""
        if memb_host is not None:
            self.memb.copy_(torch.from_numpy(memb_host))
        if self.graph is None:
            return self.body()
        with torch.cuda.device(self.device):  # the graph's own card
            self.graph.replay()
        cuda_groupby.count_replay(self.launches)
        return [t.clone() for t in self.outputs]


def _kernel_class(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "dense"


class DistributedEngine:
    """Executes GroupBy, Timeseries and TopN specs over a mesh.

    `mesh` defaults to every visible card on the data axis (`make_mesh()`,
    which raises without a card: pass a mesh of CPU devices to run on the
    host).  A slice mesh (`make_slice_mesh`) drives the arena's placement
    and merge tree; the other paths see its devices flattened onto the data
    axis, as the reference does.  `strategy` is a class name: "auto" routes
    by the cost model; "dense" (or "cuda"), "segment" (or "scatter"),
    "sparse" and "adaptive" pin it."""

    def __init__(self, mesh: Optional[Mesh] = None, strategy: str = "auto",
                 shard_cache_bytes: Optional[int] = None):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown groupby strategy {strategy!r}; one of {STRATEGIES}")
        # the process group rides the engine's construction: a no-op in one
        # process, the rendezvous where the environment names one
        multihost.initialize()
        mesh = mesh if mesh is not None else multihost.hybrid_mesh()
        # over processes: this rank holds its run of the data axis
        self.processes, self.rank = mesh.processes, mesh.rank
        if SLICE_AXIS in mesh.shape:
            self.slice_mesh = mesh
            self.mesh = make_mesh(n_data=mesh.size, n_groups=1, devices=mesh.flat())
            self.mesh.processes, self.mesh.rank = mesh.processes, mesh.rank
        else:
            self.slice_mesh = None
            self.mesh = mesh
        self.strategy = strategy
        self.device = self.mesh.flat()[0]  # the first shard's: states merge there
        self.devices = self.mesh.distinct()
        self._refs = {d: _DeviceRef(d) for d in self.devices}
        budget = shard_cache_bytes if shard_cache_bytes is not None else _budget(self.device)
        self._shard_cache = ByteBudgetCache(budget, on_evict=self._on_evict)
        self._lowering_cache = CountBudgetCache(PROGRAM_ENTRIES)
        self._programs = CountBudgetCache(PROGRAM_ENTRIES)
        self._warm: set = set()
        self._cost_config: Optional[SessionConfig] = None
        self.arena_execution = True
        self.last_metrics = None
        self._exec_lock = threading.RLock()
        self._capture_local = threading.local()
        # what the tiers learn per query (memo_key)
        self._adaptive_kept: Dict = {}
        self._adaptive_declined: set = set()
        self._sparse_slots: Dict = {}
        self._sparse_row_capacity: Dict = {}
        self._sparse_declined: set = set()
        cfg = SessionConfig()
        self.breaker = CircuitBreaker(failure_threshold=cfg.breaker_failure_threshold,
                                      cooldown_ms=cfg.breaker_cooldown_ms)
        self._retry_attempts = cfg.retry_max_attempts
        self._retry_backoff_ms = cfg.retry_backoff_ms

    # -- configuration -------------------------------------------------------

    @property
    def cost_config(self) -> SessionConfig:
        """The constants the kernel routing prices with: the context's
        session (set on each call), else the first device's calibration."""
        if self._cost_config is None:
            self._cost_config = SessionConfig.load_calibrated(device=self.device)
        return self._cost_config

    @cost_config.setter
    def cost_config(self, cfg: SessionConfig) -> None:
        self._cost_config = cfg

    def configure_pipeline(self, config) -> None:
        """The session's `arena_execution` flag."""
        self.arena_execution = bool(config.arena_execution)

    def describe(self) -> dict:
        m = self.slice_mesh if self.slice_mesh is not None else self.mesh
        return m.describe()

    # -- residency -----------------------------------------------------------

    def _on_evict(self, key, _value) -> None:
        """A shard left the residency cache: the arena programs over its
        datasource's stacks go with it (they hold the stacks)."""
        if len(key) > 2 and key[1] == "spmd_arena":
            base = key[:4]
            for k in [k for k in self._programs if k[:4] == base]:
                self._programs.pop(k)
            self._warm = {k for k in self._warm if k[:4] != base}

    def bytes_resident(self) -> int:
        return self._shard_cache.bytes_used

    def clear_cache(self) -> None:
        with self._exec_lock:
            self._programs.clear()
            self._warm.clear()
            self._shard_cache.clear()
            self._lowering_cache.clear()

    def evict_segments(self, uids) -> None:
        """Drops the shards and programs over any retired segment uid."""
        uids = frozenset(uids)
        with self._exec_lock:
            for k in list(self._shard_cache):
                sig = k[4] if k[1] in ("col", "valid") else k[3]
                if uids.intersection(sig):
                    self._shard_cache.pop(k)

    def _place(self, key, host_fn, device, m) -> torch.Tensor:
        t = self._shard_cache.get(key)
        if t is not None:
            prof.note_residency(hit=True)
            return t
        prof.note_residency(hit=False)
        host = host_fn()
        fire("h2d")  # fault site: shard placement
        t0 = time.perf_counter()
        t = torch.from_numpy(host).to(device)
        dt = time.perf_counter() - t0
        m.h2d_ms += dt * 1e3
        m.h2d_bytes += int(host.nbytes)
        prof.record_h2d(int(host.nbytes), dt)
        self._shard_cache[key] = t
        return t

    def _owned_data(self) -> range:
        """The data-axis shards this process holds (all in one process)."""
        return multihost.owned(self.mesh.shape[DATA_AXIS], self.processes, self.rank)

    def _row_shards(self, ds: DataSource, names, segs, m) -> Tuple[List[Optional[Dict]], int]:
        """Each mesh position's columns over `segs` (row-major positions;
        the data shard's rows, replicated across the groups axis): the
        scope's rows in canonical order, padded to a multiple of (data-axis
        size x ROW_PAD), split into equal contiguous shards.  A device
        holding a run of consecutive data shards holds them as one tensor,
        each shard a view of it.  Only this process's data shards are
        built, from the segments that overlap them (`multihost.local_rows`);
        another process's positions are None.  Returns (columns per
        position, rows per shard)."""
        nd, ng = self.mesh.shape[DATA_AXIS], self.mesh.shape[GROUPS_AXIS]
        total = sum(s.num_rows_padded for s in segs)
        chunk = nd * ROW_PAD
        padded = -(-max(total, 1) // chunk) * chunk
        local = padded // nd
        sig = tuple(s.uid for s in segs)
        grid = self.mesh.devices
        mine = self._owned_data()
        runs: Dict[torch.device, List[Tuple[int, int]]] = {}
        for dev in self.devices:
            held = sorted({d for d in mine for g in range(ng) if grid[d, g] == dev})
            out: List[Tuple[int, int]] = []
            for d in held:
                if out and out[-1][0] + out[-1][1] == d:
                    out[-1] = (out[-1][0], out[-1][1] + 1)
                else:
                    out.append((d, 1))
            runs[dev] = out

        def host(name, lo, hi):
            if name == SEGMENT_POSITION:
                return multihost.local_rows(
                    segs, lambda s: np.arange(s.num_rows_padded, dtype=np.int32), lo, hi, 0,
                    np.int32)
            if name is None:
                return multihost.local_rows(segs, lambda s: s.valid, lo, hi, False, bool)
            return multihost.local_rows(segs, lambda s: s.column(name), lo, hi,
                                        -1 if name in ds.dicts else 0)

        shards: Dict[Tuple[torch.device, int], Dict] = {}
        for dev, dev_runs in runs.items():
            for d0, n in dev_runs:
                for name in list(names) + [None]:
                    tag = ("valid",) if name is None else ("col", name)
                    key = (ds.name, tag[0], tag[1:], nd, sig, str(dev), d0, n)
                    t = self._place(
                        key, lambda name=name, d0=d0, n=n: np.ascontiguousarray(
                            host(name, d0 * local, (d0 + n) * local)), dev, m)
                    for k in range(n):
                        shards.setdefault((dev, d0 + k), {})[
                            "__valid" if name is None else name] = t[k * local:(k + 1) * local]
        out: List[Optional[Dict]] = []
        for d in range(nd):
            for g in range(ng):
                if d not in mine:
                    out.append(None)
                    continue
                cols = dict(shards[(grid[d, g], d)])
                if ds.time_column and ds.time_column in cols:
                    cols["__time"] = cols[ds.time_column]
                out.append(cols)
        return out, local

    # -- routing -------------------------------------------------------------

    def _lowering_for(self, q: Q.GroupByQuery, ds: DataSource):
        from ..exec.lowering import _query_key, lower_groupby

        key = _query_key(q, ds)
        lw = self._lowering_cache.get(key)
        if lw is None:
            lw = lower_groupby(q, ds)
            self._lowering_cache[key] = lw
        return lw

    def _groups_split(self, G: int) -> Tuple[int, int]:
        """(ng, Gl): group-domain shard count and per-device slice size.  The
        axis must divide G; otherwise the groups are replicated."""
        ng = self.mesh.shape[GROUPS_AXIS]
        if G % ng:
            ng = 1
        return ng, G // max(ng, 1)

    def _kernel_for(self, cls: str, Gl: int, device=None) -> str:
        """The per-shard kernel strategy of a dense-state class at the
        per-device group count: the kernel (its plain version on the CPU)
        up to SCATTER_CUTOVER, the scatter above it or when asked."""
        if cls in ("segment", "scatter"):
            return "segment"
        k = _kernel_class(device or self.device)
        return "segment" if k == "cuda" and Gl > SCATTER_CUTOVER else k

    def _route_class(self, q, ds: DataSource, lowering, qkey, strategy=None) -> str:
        """The query's class on the mesh: `strategy` (None: the engine's)
        when it pins one, else the cost model's, with the decline memos."""
        from ..plan.cost import choose_query_kernel

        exclude: List[str] = []
        if qkey in self._adaptive_declined:
            exclude.append("adaptive")
        if qkey in self._sparse_declined:
            exclude.append("sparse")
        s = self.strategy if strategy is None else strategy
        if s == "cuda":
            s = "dense"
        if s == "scatter":
            s = "segment"
        if s != "auto" and s not in exclude:
            return s
        return choose_query_kernel(q, ds, lowering.num_groups, self.cost_config,
                                   exclude=tuple(exclude), device=self.device)

    # -- entry points --------------------------------------------------------

    def execute(self, q: Q.QuerySpec, ds: DataSource, strategy: Optional[str] = None):
        """One GroupBy-family query's frame under `strategy` (None: the
        engine's), under the retry policy."""
        inner, shape = self._groupby_family(q, ds)
        if inner is None:
            raise NotImplementedError(f"{type(q).__name__} does not run on the mesh")
        from ..exec.lowering import groupby_with_time_granularity

        inner = groupby_with_time_granularity(inner)
        df = run_device_attempts(
            self, lambda: self._execute_groupby_once(inner, ds, strategy),
            lambda: self.evict_query_state(inner, ds), what="mesh device")
        return shape(df)

    def evict_query_state(self, q: Q.GroupByQuery, ds: DataSource) -> None:
        """What a failed dispatch may have poisoned: the query's lowerings
        and programs, and the datasource's shards."""
        from ..exec.lowering import _query_key

        with self._exec_lock:
            base = _query_key(q, ds)
            for k in [k for k in self._lowering_cache if k[:len(base)] == base]:
                self._lowering_cache.pop(k)
            for k in [k for k in self._programs if k[4] == base]:
                self._programs.pop(k)
            for k in [k for k in self._shard_cache if k[0] == ds.name]:
                self._shard_cache.pop(k)

    def _groupby_family(self, q: Q.QuerySpec, ds: DataSource):
        from ..exec.finalize import finalize_timeseries, finalize_topn
        from ..exec.lowering import timeseries_to_groupby, topn_to_groupby

        if isinstance(q, Q.TimeseriesQuery):
            return timeseries_to_groupby(q), lambda df: finalize_timeseries(df, q, ds)
        if isinstance(q, Q.TopNQuery):
            return topn_to_groupby(q), lambda df: finalize_topn(df, q)
        if isinstance(q, Q.GroupByQuery):
            return q, lambda df: df
        return None, None

    def _metrics(self, q, ds, lowering, segs, cls):
        from ..exec.engine import _bytes_scanned
        from ..exec.metrics import QueryMetrics

        return QueryMetrics(
            query_type="groupBy", strategy=cls, datasource=ds.name, device=str(self.device),
            query_id=current_query_id(), distributed=True,
            mesh_shape=tuple(self.mesh.shape.values()),
            rows_scanned=sum(s.num_rows for s in segs),
            bytes_scanned=_bytes_scanned(segs, lowering.columns),
            segments=len(segs), num_groups=lowering.num_groups,
        )

    def _execute_groupby_once(self, q: Q.GroupByQuery, ds: DataSource, strategy=None):
        from ..exec.engine import segments_in_scope
        from ..exec.lowering import memo_key

        if current_partial() is None:
            checkpoint("mesh.dispatch")
        else:
            checkpoint_partial("mesh.dispatch")
        t_total = time.perf_counter()
        lowering = self._lowering_for(q, ds)
        segs = segments_in_scope(q, ds)
        qkey = memo_key(q, ds)
        cls = self._route_class(q, ds, lowering, qkey, strategy)
        m = self._metrics(q, ds, lowering, segs, cls)
        outcome = "error"
        try:
            with self._exec_lock:
                fire("device_dispatch")
                low, host = self._dispatch(q, ds, lowering, segs, qkey, cls, m, strategy)
            t0 = time.perf_counter()
            with span(SPAN_FINALIZE):
                from ..exec.finalize import finalize_groupby

                sums, mins, maxs, sketches, slot_gids = host
                df = finalize_groupby(q, low.dims, low.la, sums, mins, maxs, sketches,
                                      slot_gids=slot_gids)
            m.finalize_ms = (time.perf_counter() - t0) * 1e3
            outcome = "ok"
        except DeadlineExceeded:
            m.deadline_exceeded = True
            outcome = "deadline"
            raise
        finally:
            m.total_ms = (time.perf_counter() - t_total) * 1e3
            self._finish_metrics(m, outcome)
        return df

    def _finish_metrics(self, m, outcome: str) -> None:
        m.bytes_resident = self.bytes_resident()
        pc = current_partial()
        if pc is not None and pc.is_partial:
            m.partial = True
            m.coverage = pc.coverage()
            m.rows_seen = pc.rows_seen
            m.delta_rows_seen = pc.delta_rows_seen
        self.last_metrics = m
        record_query_metrics(m, "partial" if outcome == "ok" and m.partial else outcome)

    def _dispatch(self, q, ds, lowering, segs, qkey, cls, m, strategy=None):
        """The tiers the class asks for, then the dense-state classes:
        (the lowering that answered, its host state (sums, mins, maxs,
        sketches in the reference's layout, slot gids or None))."""
        G = lowering.num_groups
        if cls in ("sparse", "adaptive") and (G <= SCATTER_CUTOVER or not lowering.dims):
            cls = "dense"  # no tier that narrow
        if cls == "adaptive":
            out = self._execute_adaptive(q, ds, lowering, segs, qkey, m)
            if out is not None:
                m.strategy = "adaptive"
                return out
            cls = self._route_class(q, ds, lowering, qkey, strategy)
            if cls == "adaptive":
                cls = "dense"
        if cls == "sparse":
            out = self._execute_sparse(q, ds, lowering, segs, qkey, m)
            if out is not None:
                m.strategy = "sparse"
                return out
            cls = "segment"
        ng, Gl = self._groups_split(G)
        kstrat = self._kernel_for(cls, Gl)
        m.strategy = kstrat
        host = self._execute_arena(ds, [lowering], [q], [segs], [kstrat], m)
        if host is None:
            host = self._execute_dense_state(ds, lowering, segs, kstrat, m)
        else:
            host = host[0]
        self._capture_state(*host[:4])
        return lowering, host

    def execute_groupby_batch(self, queries, ds: DataSource, set_labels=None,
                              strategies=None) -> List:
        """The sets of a CUBE or ROLLUP, one after another on the mesh, each
        accounted under its set label by a partial collector."""
        pc = current_partial()
        strategies = list(strategies or [None] * len(queries))
        out = []
        for i, q in enumerate(queries):
            if pc is not None and set_labels is not None:
                pc.set_label = set_labels[i]
            out.append(self.execute(q, ds, strategies[i]))
        return out

    # -- dense-state path ----------------------------------------------------

    def _positions(self, ng: int) -> List[int]:
        """The mesh positions (row-major) of this process that compute a
        query whose group domain splits `ng` ways: every position when the
        groups axis shards it, else the first group column of each data
        shard (the others would compute the same replica)."""
        NG = self.mesh.shape[GROUPS_AXIS]
        return [d * NG + g for d in self._owned_data() for g in range(ng)]

    def _shard_state(self, lowering, cols: Dict, kstrat: str, g: int, ng: int, Gl: int):
        """One position's partial state over its rows: (sums, mins, maxs,
        sketch states), keeping only group slice g of ng."""
        from ..exec.engine import sketch_partials

        la = lowering.la
        if la.sketch_aggs:
            cols = lowering.add_virtual(dict(cols))
        gid, mask, sv, mmv, mmm = lowering.row_arrays(cols)
        if ng > 1:
            gid = gid - g * Gl
            mask = mask & (gid >= 0) & (gid < Gl)
            gid = torch.where(mask, gid, torch.zeros_like(gid))
        s, mn, mx = _blocked_partial_aggregate(
            gid, mask, sv, mmv, mmm, num_groups=Gl, num_min=len(la.min_names),
            num_max=len(la.max_names), strategy=kstrat)
        if not la.sketch_aggs:
            return s, mn, mx, {}
        sub = lowering
        if ng > 1:
            import dataclasses

            sub = dataclasses.replace(lowering, num_groups=Gl)
        return s, mn, mx, sketch_partials(sub, cols, gid, mask)

    def merge_positions(self, lowering, parts, ng: int, tree: str = "flat"):
        """This process's positions' states (row-major over (data, groups))
        merged over the data axis per group slice by `tree` (on a slice
        mesh, "hierarchical" folds each slice first), across processes in
        rank order, the slices concatenated on the first shard's device:
        (sums, mins, maxs, sketch states).  The sketch merges are exact in
        any order, so they fold flat."""
        from ..exec.lowering import sketch_ops

        nd = len(parts) // ng
        rows = self._arena_mesh() if ng == 1 else self.mesh
        across = self.processes > 1
        slices = []
        for g in range(ng):
            col = [parts[d * ng + g] for d in range(nd)]
            s = merge_tree(rows, tree, [p[0] for p in col], "sum")
            mn = merge_tree(rows, tree, [p[1] for p in col], "min")
            mx = merge_tree(rows, tree, [p[2] for p in col], "max")
            sk = {}
            for agg in lowering.la.sketch_aggs:
                sts = [p[3][agg.name] for p in col]
                if isinstance(agg, (A.HyperUnique, A.CardinalityAgg)):
                    sk[agg.name] = reduce_states(sts, "max", across_processes=across)
                else:
                    ops = sketch_ops(agg)
                    gathered = gather_states(sts, across_processes=across)
                    acc = gathered[0]
                    for x in gathered[1:]:
                        acc = ops.merge_states(acc, x, agg)
                    sk[agg.name] = acc
            slices.append((s, mn, mx, sk))
        if ng == 1:
            return slices[0]
        dev = self.device
        cat = [torch.cat([sl[i].to(dev) for sl in slices]) for i in range(3)]
        sk = {a.name: torch.cat([sl[3][a.name].to(dev) for sl in slices])
              for a in lowering.la.sketch_aggs}
        return (*cat, sk)

    def _host_state(self, la, state):
        """A merged device state fetched in one copy: (sums, mins, maxs,
        sketch states in the reference's layout, None)."""
        from ..exec.engine import sketch_states_to_reference

        sums, mins, maxs, sketches = state
        parts = [t.to(self.device) for t in (sums, mins, maxs)]
        prof.fetch_sync(self.device)
        flat = torch.cat([t.reshape(-1) for t in parts]).cpu().numpy()
        out, at = [], 0
        for t in parts:
            out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
            at += t.numel()
        return (*out, sketch_states_to_reference(la, sketches), None)

    def _execute_dense_state(self, ds, lowering, segs, kstrat: str, m):
        """Row shards over the scope, each position's kernel launched before
        any result is read, the merge, one fetch."""
        from ..exec.lowering import empty_partials

        la, G = lowering.la, lowering.num_groups
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))
        if not segs:
            return self._host_state(la, empty_partials(la, G, self.device))
        from ..plan.cost import groupby_state_bytes

        ng, Gl = self._groups_split(G)
        nd = self.mesh.shape[DATA_AXIS]
        m.est_collective_ms = (2.0 * (nd - 1) / nd * groupby_state_bytes(lowering.query, Gl, None)
                               / self.cost_config.collective_bytes_per_us / 1e3)
        tree = self._merge_tree_for(lowering.query, lowering)[0]
        m.merge_tree = tree
        names = list(lowering.columns)
        if any(isinstance(a, A.QuantilesSketch) for a in lowering.la.sketch_aggs):
            names.append(SEGMENT_POSITION)  # the sample does not depend on the shards
        cols, _local = self._row_shards(ds, names, segs, m)
        at = self._positions(ng)
        devs = [self.mesh.flat()[p] for p in at]
        t0 = time.perf_counter()
        with span(SPAN_COLLECTIVE_MERGE, merge_tree=tree, shards=len(at)):
            with prof.shard_timer(devs) as clock:
                parts = []
                for i, p in enumerate(at):  # every shard launched before any fetch
                    clock.start(i)
                    parts.append(self._shard_state(lowering, cols[p], kstrat, i % ng, ng, Gl))
                    clock.stop(i)
                m.dispatch_count += 1
            state = self.merge_positions(lowering, parts, ng, tree)
            host = self._host_state(la, state)
        m.shard_device_ms = clock.shard_ms() if clock.mode else []
        m.device_ms += (time.perf_counter() - t0) * 1e3
        if pc is not None:
            pc.add_seen(len(segs), *row_counts(segs))
        return host

    # -- sparse tier ---------------------------------------------------------

    def _sparse_pass(self, lowering, cols, slots, cap, inner):
        """One sparse pass: every position's slot-compacted state (its
        blocks' merged in row order), launched before any fetch,
        all-gathered over the data axis (and the processes) and folded with
        `merge_sparse_states` in shard order per group slice.  Returns the
        merged state per slice."""
        la, G = lowering.la, lowering.num_groups
        ng, Gl = self._groups_split(G)
        at = self._positions(ng)
        nd = len(at) // ng
        states = []
        for i, p in enumerate(at):
            gid, mask, sv, mmv, mmm = lowering.row_arrays(dict(cols[p]))
            if ng > 1:
                off = (i % ng) * Gl
                mask = mask & (gid >= off) & (gid < off + Gl)
            st = None
            for lo, hi in _row_blocks(gid.shape[0]):  # merged in row order
                b = sg.sparse_partial_aggregate(
                    gid[lo:hi], mask[lo:hi], sv[lo:hi], mmv[lo:hi], mmm[lo:hi],
                    num_groups=G, num_min=len(la.min_names), num_max=len(la.max_names),
                    slots=slots, inner_strategy=inner, row_capacity=cap)
                st = b if st is None else sg.merge_sparse_states(st, b, G)
            states.append(st)
        out = []
        for g in range(ng):
            col = [states[d * ng + g] for d in range(nd)]
            keys = _SPARSE_STATE_KEYS + _SPARSE_FLAG_KEYS
            gathered = {k: gather_states([st[k] for st in col],
                                         across_processes=self.processes > 1) for k in keys}
            acc = {k: gathered[k][0] for k in keys}
            for i in range(1, len(gathered[keys[0]])):
                acc = sg.merge_sparse_states(acc, {k: gathered[k][i] for k in keys}, G)
            out.append(acc)
        return out

    def _execute_sparse(self, q, ds, lowering, segs, qkey, m):
        """The sparse tier over the mesh with both ladders; None when the
        slots ladder is exhausted (remembered; the scatter answers)."""
        from ..exec.sparse_exec import first_row_capacity, next_row_capacity, next_slots

        if lowering.la.sketch_aggs or not lowering.dims:
            self._sparse_declined.add(qkey)
            m.declines.append("sparse: sketch aggregations or no dimensions")
            return None
        pc = current_partial()
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(segs), *row_counts(segs))
        if not segs:
            from ..exec.lowering import empty_partials

            return lowering, self._host_state(lowering.la, empty_partials(
                lowering.la, lowering.num_groups, self.device))
        cols, local = self._row_shards(ds, lowering.columns, segs, m)
        if qkey in self._sparse_row_capacity:
            cap = self._sparse_row_capacity[qkey]
        else:
            cap = first_row_capacity(q, ds, min(local, SHARD_BLOCK_ROWS))
        slots = self._sparse_slots.get(qkey, sg.SPARSE_SLOTS)
        inner = _kernel_class(self.device)
        t0 = time.perf_counter()
        while True:
            m.sparse_passes += 1
            with span(SPAN_SPARSE_DISPATCH, slots=slots, shards=len(cols)):
                merged = self._sparse_pass(lowering, cols, slots, cap, inner)
                m.dispatch_count += 1
                flags = torch.stack([torch.stack([st[k].to(torch.int64).to(self.device)
                                                  for k in _SPARSE_FLAG_KEYS])
                                     for st in merged]).cpu().numpy()
            ov, rov, n_rows, n_real = flags[:, 0], flags[:, 1], flags[:, 2], flags[:, 3]
            if cap is not None and rov.any():
                n = int(n_rows.max())
                new_cap = self._sparse_row_capacity[qkey] = next_row_capacity(n, cap)
                log.info("mesh sparse row compaction overflowed %d of %d; rerunning at %s",
                         n, cap, "a full-shard sort" if new_cap is None else new_cap)
                cap = new_cap
                continue
            if ov.any():
                n_est = int(n_real.max())
                new_slots = next_slots(n_est, slots)
                if new_slots is None:
                    reason = (f"sparse: the slots ladder is exhausted at {slots} "
                              f"(~{n_est} groups)")
                    self._sparse_declined.add(qkey)
                    m.declines.append(reason)
                    return None
                self._sparse_slots[qkey] = new_slots
                slots = new_slots
                cap = self._sparse_row_capacity.get(qkey, cap)
                continue
            break
        m.sparse_slots = slots
        m.sparse_row_capacity = 0 if cap is None else cap
        m.inner_strategy = inner
        state = {k: torch.cat([st[k].to(self.device) for st in merged])
                 for k in _SPARSE_STATE_KEYS}
        sums, mins, maxs, _, _ = self._host_state(
            lowering.la, (state["sums"], state["mins"], state["maxs"], {}))
        gids = state["gids"].cpu().numpy()
        m.device_ms += (time.perf_counter() - t0) * 1e3
        if pc is not None:
            pc.add_seen(len(segs), *row_counts(segs))
        return lowering, (sums, mins, maxs, {}, gids)

    # -- adaptive tier -------------------------------------------------------

    def _presence(self, q, ds, lowering, segs, m) -> List[np.ndarray]:
        """Rows per code of each grouped dimension under the row mask: every
        data shard's counts (its blocks' summed in row order), summed
        across shards and processes."""
        from ..exec.adaptive_exec import presence_columns, presence_one

        need = presence_columns(q, lowering, ds)
        cols, local = self._row_shards(ds, need, segs, m)
        ng = self.mesh.shape[GROUPS_AXIS]
        per_shard = []
        with span(SPAN_ADAPTIVE_PROBE, shards=len(cols) // ng):
            for p in range(0, len(cols), ng):  # one position per data shard
                if cols[p] is None:
                    continue  # another process's
                c = lowering.add_virtual(dict(cols[p]))
                counts = None
                for lo, hi in _row_blocks(local):
                    counts = presence_one(lowering, {k: v[lo:hi] for k, v in c.items()},
                                          counts, _kernel_class(self.mesh.flat()[p]))
                per_shard.append(torch.cat(counts))
            m.dispatch_count += 1
            host = reduce_states(per_shard, "sum",
                                 across_processes=self.processes > 1).cpu().numpy()
        out, at = [], 0
        for d in lowering.dims:
            out.append(host[at:at + d.cardinality])
            at += d.cardinality
        return out

    def _execute_adaptive(self, q, ds, lowering, segs, qkey, m):
        """Presence counts over the mesh, then the dense-state pass over the
        compacted lowering; None when it declines (remembered)."""
        from ..exec.adaptive_exec import compacted_lowering, kept_codes
        from ..exec.lowering import _query_key, empty_partials
        from ..plan.cost import choose_kernel_strategy

        kept, reason = kept_codes(self._adaptive_kept, qkey, q, lowering, ds, segs,
                                  lambda: self._presence(q, ds, lowering, segs, m), m)
        if reason is not None:
            self._adaptive_declined.add(qkey)
            return None
        Gc = m.compact_groups
        if Gc == 0:
            m.inner_strategy = "none"
            pc = current_partial()
            if pc is not None:
                rows = row_counts(segs)
                pc.begin_pass()
                pc.add_scope(len(segs), *rows)
                pc.add_seen(len(segs), *rows)
            return lowering, self._host_state(lowering.la,
                                              empty_partials(lowering.la, 0, self.device))
        extra = ("adaptive",) + tuple(kd.tobytes() for kd in kept)
        key = _query_key(q, ds) + extra
        clow = self._lowering_cache.get(key)
        if clow is None:
            clow = compacted_lowering(lowering, kept)
            self._lowering_cache[key] = clow
        cls = choose_kernel_strategy(ds.num_rows, clow.num_groups, self.cost_config,
                                     device=self.device)
        _, Gl = self._groups_split(clow.num_groups)
        m.inner_strategy = self._kernel_for(cls, Gl)
        return clow, self._execute_dense_state(ds, clow, segs, m.inner_strategy, m)

    # -- the arena (parallel/spmd_arena.py) ----------------------------------

    def _arena_mesh(self) -> Mesh:
        return self.slice_mesh if self.slice_mesh is not None else self.mesh

    def _row_devices(self) -> List[torch.device]:
        """The row devices in shard order: every position of the arena mesh
        (its groups axis is 1 wherever the arena runs)."""
        return self._arena_mesh().flat()

    def _owned_row_devices(self) -> List[Tuple[int, torch.device]]:
        """(r, device) of the row devices this process holds: their blocks
        alone are stacked, placed and folded here."""
        devs = self._row_devices()
        return [(r, devs[r]) for r in multihost.owned(len(devs), self.processes, self.rank)]

    def _arena_layout(self, ds: DataSource, m=None):
        """The stacked layout of `ds`, or None where the arena declines:
        the session flag or the per-query opt-out, a groups axis, fewer
        than two segments, or unequal segment shapes."""
        from ..exec import arena as arena_mod

        reason = None
        if not self.arena_execution:
            reason = "arena: arena_execution is off"
        elif arena_mod.query_disabled():
            reason = "arena: disabled for this query"
        elif self.mesh.shape[GROUPS_AXIS] > 1:
            reason = "arena: the groups axis shards the group domain"
        layout = None
        if reason is None:
            layout = spmd_arena.plan_spmd_layout(ds, len(self._row_devices()))
            if layout is None:
                reason = "arena: the segments do not stack (fewer than two, or unequal shapes)"
        if reason is not None and m is not None:
            m.declines.append(reason)
        return layout

    def _merge_tree_for(self, q, lowering) -> Tuple[str, float, float]:
        """(tree, flat_us, hier_us): the cost model's merge tree for this
        query's state on a slice mesh (the session's `collective_bytes_per_us`
        and `dcn_bytes_per_us` price it); "flat" on a data mesh, where the
        two trees are one reduction."""
        from ..plan.cost import choose_merge_tree, groupby_state_bytes

        sbytes = groupby_state_bytes(q, lowering.num_groups, None)
        if self.slice_mesh is not None:
            ns, nd = self.slice_mesh.shape[SLICE_AXIS], self.slice_mesh.shape[DATA_AXIS]
        else:
            ns, nd = 1, self.mesh.shape[DATA_AXIS]
        tree, flat_us, hier_us = choose_merge_tree(sbytes, ns, nd, self.cost_config)
        if self.processes > 1:
            tree = "hierarchical"  # the processes are the slices
        elif self.slice_mesh is None:
            tree = "flat"
        return tree, flat_us, hier_us

    def _arena_stacks(self, ds, layout, names, m) -> Dict[int, Dict]:
        """This process's row devices' `[L, R]` stacks of `names` and the
        validity mask (None), by row device, placed once per datasource
        version."""
        out = {}
        base = (ds.name, "spmd_arena", layout.ndt, layout.uids)
        t0 = time.perf_counter()
        placed = m.h2d_bytes
        with span(SPAN_ARENA_BUILD, datasource=ds.name, blocks=layout.B, shards=layout.ndt):
            for r, dev in self._owned_row_devices():
                stacks = {}
                for name in list(names) + [None]:
                    key = base + (name, r, str(dev))
                    stacks[name] = self._place(
                        key, lambda name=name, r=r: spmd_arena.stack_column(layout, name, r),
                        dev, m)
                out[r] = stacks
        if m.h2d_bytes > placed:
            span_event("shard_h2d", datasource=ds.name, bytes=m.h2d_bytes - placed,
                       shards=layout.ndt, ms=round((time.perf_counter() - t0) * 1e3, 3))
        return out

    def _program(self, key, r, dev, make_body, Lk, n, m, capturable: bool):
        """Row device r's program under `key`: the body eagerly on a key's
        first run (which marks it warm), captured on a card at its second,
        replayed after."""
        prog = self._programs.get(key)
        prof.note_program_cache("arena-spmd", hit=prog is not None)
        if prog is not None:
            return prog
        memb = torch.zeros((max(Lk, 1), n), dtype=torch.bool, device=dev)
        body = make_body(memb)
        if dev.type != "cuda":
            prog = ShardProgram(dev, body, memb)
            self._programs[key] = prog
            return prog
        if not capturable or key not in self._warm:
            self._warm.add(key)
            return ShardProgram(dev, body, memb)
        from ..exec import arena as arena_mod

        with torch.cuda.device(dev):  # captured on this card's stream
            graph, out, launches, ms = arena_mod._build(self._refs[dev], body, None, "arena-spmd")
        prog = ShardProgram(dev, body, memb, graph, out, launches, ms)
        self._programs[key] = prog
        m.graph_captures += 1
        m.capture_ms += ms
        return prog

    def _chunked(self) -> bool:
        """Deadline chunking, in one process only: ranks that stopped at
        different steps would merge different scopes."""
        if self.processes > 1:
            return False
        d = current_deadline()
        import math

        return (d is not None and math.isfinite(d.timeout_ms)) or site_armed(SEGMENT_LOOP_SITE)

    def _execute_arena(self, ds, lowerings, inners, member_segs, kstrats, m):
        """The members' scopes on the stacked layout: one program per row
        device (a CUDA graph from a scope's second run on a card), each
        launched before any merge, then the merge by the cost model's tree
        and one fetch.  Returns each member's host state, or None where
        the arena declines (sketches, the layout)."""
        if any(lw.la.sketch_aggs for lw in lowerings):
            m.declines.append("arena: sketch aggregations are not captured")
            return None
        layout = self._arena_layout(ds, m)
        if layout is None:
            return None
        from ..exec.lowering import _query_key, empty_partials
        from ..serve.fusion import shared_row_plan

        n = len(lowerings)
        pc = current_partial()
        scopes = [sorted(layout.index[s.uid] for s in segs) for segs in member_segs]
        blocks = sorted({b for sc in scopes for b in sc})
        if pc is not None:
            pc.begin_pass()
            pc.add_scope(len(blocks), *row_counts([layout.segs[b] for b in blocks]))
        if not blocks:
            return [self._host_state(lw.la, empty_partials(lw.la, lw.num_groups, self.device))
                    for lw in lowerings]
        j_lo, Lk = spmd_arena.scope_window(layout, blocks)
        memb = spmd_arena.membership_matrix(layout, scopes)
        tree, flat_us, hier_us = self._merge_tree_for(inners[0], lowerings[0])
        m.merge_tree = tree
        m.est_collective_ms = min(flat_us, hier_us) / 1e3
        names = list(dict.fromkeys(c for lw in lowerings for c in lw.columns))
        stacks = self._arena_stacks(ds, layout, names, m)
        share = shared_row_plan(inners) if n > 1 else None
        qkeys = tuple(_query_key(q, ds) for q in inners)
        base = (ds.name, "spmd_arena", layout.ndt, layout.uids,
                qkeys[0] if n == 1 else qkeys, tuple(kstrats), layout.R)
        capturable = "segment" not in kstrats
        if not capturable:
            m.declines.append("arena: the scatter strategy's nonzero has a data-dependent size")
        devs = [dev for _, dev in self._owned_row_devices()]
        t0 = time.perf_counter()
        if self._chunked():
            carries = self._arena_steps(ds, layout, lowerings, kstrats, stacks, memb, scopes,
                                        j_lo, Lk, base, share, capturable, m)
        else:
            carries = []
            with span(SPAN_COLLECTIVE_MERGE, merge_tree=tree, shards=layout.ndt, window=Lk,
                      fused=n):
                span_event("merge_tree", tree=tree, flat_us=round(flat_us, 3),
                           hier_us=round(hier_us, 3), shards=layout.ndt,
                           slices=self._slice_count())
                with prof.shard_timer(devs) as clock:
                    for i, (r, dev) in enumerate(self._owned_row_devices()):
                        # every device launched before the merge
                        steps = [(k, j_lo + k) for k in range(Lk)
                                 if layout.block(r, j_lo + k) is not None]
                        key = base + ("window", j_lo, Lk, r, str(dev))

                        def make_body(buf, steps=steps, r=r):
                            return spmd_arena.shard_body(lowerings, kstrats, stacks[r], steps,
                                                         buf, ds.time_column, share)

                        prog = self._program(key, r, dev, make_body, Lk, n, m, capturable)
                        clock.start(i)
                        outs = prog.run(spmd_arena.shard_membership(layout, memb, r, j_lo, Lk))
                        clock.stop(i)
                        m.graph_replays += prog.graph is not None
                        carries.append([tuple(outs[3 * i:3 * i + 3]) for i in range(n)])
                m.dispatch_count += 1
                m.arena_segments += len(blocks)
            m.shard_device_ms = clock.shard_ms() if clock.mode else []
            if pc is not None:
                pc.add_seen(len(blocks), *row_counts([layout.segs[b] for b in blocks]))
        hosts = []
        amesh = self._arena_mesh()
        with span(SPAN_COLLECTIVE_MERGE, merge_tree=tree, shards=layout.ndt, fetch=1):
            for i, lw in enumerate(lowerings):
                per = [c[i] for c in carries]
                state = tuple(merge_tree(amesh, tree, [p[k] for p in per], op)
                              for k, op in enumerate(("sum", "min", "max")))
                hosts.append(self._host_state(lw.la, (*state, {})))
        m.device_ms += (time.perf_counter() - t0) * 1e3
        return hosts

    def _arena_steps(self, ds, layout, lowerings, kstrats, stacks, memb, scopes, j_lo, Lk,
                     base, share, capturable, m):
        """Deadline chunking: a step at a time, the checkpoint
        `mesh.segment_loop` and the `device_dispatch` fault site before
        each; each device's step program gives its block's partials, folded
        on the device by membership; coverage counted per step on the host
        (step j covers the in-scope blocks {j ndt + r}).  Returns each
        device's carries."""
        pc = current_partial()
        devs = self._row_devices()
        n = len(lowerings)
        carries = [[spmd_arena.init_member(lw, dev) for lw in lowerings] for dev in devs]
        in_scope = {b for sc in scopes for b in sc}
        for k in range(Lk):
            j = j_lo + k
            if checkpoint_partial(SEGMENT_LOOP_SITE):
                break
            fire("device_dispatch")
            seen = []
            with span(SPAN_SEGMENT_DISPATCH, arena=1, chunk=k, shards=layout.ndt):
                for r, dev in enumerate(devs):
                    b = layout.block(r, j)
                    if b is None:
                        continue
                    key = base + ("step", j, r, str(dev))

                    def make_body(_buf, r=r, j=j):
                        return spmd_arena.step_body(lowerings, kstrats, stacks[r], j,
                                                    ds.time_column, share)

                    prog = self._program(key, r, dev, make_body, 1, n, m, capturable)
                    outs = prog.run()
                    m.graph_replays += prog.graph is not None
                    flags = torch.from_numpy(memb[layout.pos(b)].copy()).to(dev)
                    for i in range(n):
                        carries[r][i] = spmd_arena.fold_member(
                            carries[r][i], tuple(outs[3 * i:3 * i + 3]), flags[i])
                    if b in in_scope:
                        seen.append(layout.segs[b])
            m.dispatch_count += 1
            m.arena_segments += len(seen)
            if pc is not None:
                pc.add_seen(len(seen), *row_counts(seen))
        return carries

    def _slice_count(self) -> int:
        return self.slice_mesh.shape[SLICE_AXIS] if self.slice_mesh is not None else 1

    # -- host partial states (the result cache's delta reuse) ----------------

    @contextlib.contextmanager
    def state_capture(self):
        """Captures the merged host partial state of the next execution on
        this thread ({"sums", "mins", "maxs", "sketches"}), or None when a
        tier answered or a deadline cut it."""
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

    def groupby_partials_host(self, q: Q.QuerySpec, ds: DataSource, within_uids=None,
                              strategy: Optional[str] = None):
        """The merged host partial state of a GroupBy-family query over its
        in-scope segments whose uid is in `within_uids` (None: the whole
        scope), by its dense-state class on the mesh (no tier).  Returns
        (state, the QueryMetrics of the pass)."""
        from ..exec.engine import segments_in_scope
        from ..exec.lowering import groupby_with_time_granularity, memo_key

        inner, _ = self._groupby_family(q, ds)
        if inner is None:
            raise ValueError(f"{type(q).__name__} has no partial state")
        inner = groupby_with_time_granularity(inner)
        lowering = self._lowering_for(inner, ds)
        segs = segments_in_scope(inner, ds)
        if within_uids is not None:
            w = frozenset(within_uids)
            segs = [s for s in segs if s.uid in w]
        cls = self._route_class(inner, ds, lowering, memo_key(inner, ds), strategy)
        if cls in ("sparse", "adaptive"):
            cls = "segment"  # a tier's state is not over the query's groups
        _, Gl = self._groups_split(lowering.num_groups)
        kstrat = self._kernel_for(cls, Gl)
        m = self._metrics(inner, ds, lowering, segs, kstrat)
        t0 = time.perf_counter()
        with self._exec_lock:
            host = self._execute_arena(ds, [lowering], [inner], [segs], [kstrat], m)
            host = host[0] if host is not None else self._execute_dense_state(
                ds, lowering, segs, kstrat, m)
        m.total_ms = (time.perf_counter() - t0) * 1e3
        sums, mins, maxs, sketches, _ = host
        return {"sums": sums, "mins": mins, "maxs": maxs, "sketches": sketches}, m

    def merge_groupby_states(self, q: Q.QuerySpec, ds: DataSource, a, b):
        """Two host partial states of one query merged on the host, `a`
        first (the single-device engine's merge)."""
        from ..exec.engine import Engine

        return Engine.merge_groupby_states(self, q, ds, a, b)

    def finalize_groupby_state(self, q: Q.QuerySpec, ds: DataSource, state):
        """A host partial state as the query's result frame."""
        from ..exec.engine import Engine

        return Engine.finalize_groupby_state(self, q, ds, state)

    # -- micro-batch fusion (serve/) -----------------------------------------

    def fusable(self, q: Q.QuerySpec, ds: DataSource, strategy: Optional[str] = None) -> bool:
        """May this query join a fused micro-batch on the mesh?
        GroupBy-family, no wire subtotals, no sketches, a dense-state class,
        and a datasource the arena stacks."""
        from ..exec.lowering import groupby_with_time_granularity, memo_key

        inner, _ = self._groupby_family(q, ds)
        if inner is None or inner.subtotals:
            return False
        try:
            inner = groupby_with_time_granularity(inner)
            lowering = self._lowering_for(inner, ds)
        except Exception:  # an unlowerable query declines fusion
            return False
        if lowering.la.sketch_aggs:
            return False
        cls = self._route_class(inner, ds, lowering, memo_key(inner, ds), strategy)
        if cls in ("sparse", "adaptive") and lowering.num_groups > SCATTER_CUTOVER:
            return False
        return self._arena_layout(ds) is not None

    def execute_fused(self, queries, ds: DataSource, query_ids=None, strategies=None):
        """N fusable queries as one arena dispatch per device, every
        member's fold inside it, one merge and fetch per member.  Returns
        (df, state, metrics) per member, as `exec.engine.Engine` does."""
        from ..exec.engine import _bytes_scanned, _wire_type, segments_in_scope
        from ..exec.finalize import finalize_groupby
        from ..exec.lowering import groupby_with_time_granularity, memo_key
        from ..exec.metrics import QueryMetrics

        t0 = time.perf_counter()
        queries = list(queries)
        n = len(queries)
        prof.note_fusion(n)
        query_ids = list(query_ids or [""] * n)
        asked = list(strategies or [None] * n)
        members = []
        for q in queries:
            inner, shape = self._groupby_family(q, ds)
            if inner is None:
                raise ValueError(f"{type(q).__name__} is not fusable (GroupBy-family queries only)")
            inner = groupby_with_time_granularity(inner)
            lowering = self._lowering_for(inner, ds)
            members.append((q, inner, shape, lowering, segments_in_scope(inner, ds)))
        kstrats = []
        for mb, s in zip(members, asked):
            cls = self._route_class(mb[1], ds, mb[3], memo_key(mb[1], ds), s)
            kstrats.append(self._kernel_for(cls, self._groups_split(mb[3].num_groups)[1]))
        checkpoint("engine.fused_loop")
        fire("device_dispatch")
        bm = QueryMetrics(query_type="fused", device=str(self.device), distributed=True,
                          mesh_shape=tuple(self.mesh.shape.values()))
        with self._exec_lock:
            hosts = self._execute_arena(ds, [mb[3] for mb in members], [mb[1] for mb in members],
                                        [mb[4] for mb in members], kstrats, bm)
        if hosts is None:
            out = []
            for q, qid, s in zip(queries, query_ids, asked):
                with self.state_capture() as cap:
                    df = self.execute(q, ds, s)
                mm = self.last_metrics
                if mm is not None and qid:
                    mm.query_id = qid
                out.append((df, cap["state"], mm))
            return out
        elapsed = (time.perf_counter() - t0) * 1e3
        out = []
        for i, (q, inner, shape, lowering, segs) in enumerate(members):
            sums, mins, maxs, sketches, _ = hosts[i]
            with span(SPAN_FINALIZE, member=i):
                df = shape(finalize_groupby(inner, lowering.dims, lowering.la, sums, mins,
                                            maxs, sketches))
            mm = QueryMetrics(
                query_type=_wire_type(q), strategy=kstrats[i], datasource=ds.name,
                device=str(self.device), query_id=query_ids[i], distributed=True,
                mesh_shape=tuple(self.mesh.shape.values()), merge_tree=bm.merge_tree,
                rows_scanned=sum(s.num_rows for s in segs),
                bytes_scanned=_bytes_scanned(segs, lowering.columns), segments=len(segs),
                num_groups=lowering.num_groups, h2d_bytes=bm.h2d_bytes // n,
                h2d_ms=bm.h2d_ms / n, capture_ms=bm.capture_ms,
                graph_captures=bm.graph_captures, graph_replays=bm.graph_replays,
                dispatch_count=bm.dispatch_count, arena_segments=bm.arena_segments,
                declines=list(bm.declines), total_ms=elapsed, fused_batch=n,
                bytes_resident=self.bytes_resident(),
            )
            record_query_metrics(mm, "ok")
            out.append((df, {"sums": sums, "mins": mins, "maxs": maxs, "sketches": sketches},
                        mm))
        self.last_metrics = out[-1][2] if out else None
        return out

