"""User-facing surface: register tables, run SQL, explain rewrites.

    from spark_druid_olap_tpu_torch.api import TPUOlapContext
    ctx = TPUOlapContext()                 # CUDA; device="cpu" runs on the host
    ctx.register_table("lineitem", cols, dimensions=[...], metrics=[...],
                       time_column="l_shipdate", star_schema=...)
    df  = ctx.sql("SELECT l_returnflag, sum(l_quantity) FROM lineitem "
                  "GROUP BY l_returnflag")
    print(ctx.explain("SELECT ..."))      # EXPLAIN DRUID REWRITE analog
    df  = (ctx.table("lineitem").where(col("l_quantity") > 40)
              .group_by("l_returnflag").agg(n=("count", None)).collect())

A SQL string goes through the lexer and parser (`sql/`) to a logical plan,
through the planner (`plan/`: star-join elimination, interval extraction,
aggregate mapping, TopN/Timeseries routing, and the cost model's kernel
class, `Rewrite.physical`) to a Druid query spec, through
`exec.engine.Engine` on the device under the plan's class, and through host
post-processing here (FD restores, host post-expressions, residual HAVING,
output projection).

The cost model (`plan/cost.py`) prices each class with the session's
constants: `TPUOlapContext()` loads the calibration of its device
(`SessionConfig.load_calibrated`: `calibration.torch_cuda.json` on a card,
the CPU profile on the CPU; `config.calibration_meta` says which), and
`SET` on a constant replans at once (the plan cache keys on the config).
The plan's class reaches each execution as an argument, so concurrent
queries never route each other; `ctx.engine.strategy` set to anything but
"auto" pins every query of the context to that strategy instead.

CUBE, ROLLUP and GROUPING SETS run one engine pass per set, every set
dispatched before any is fetched (`execute_grouping_sets`,
`Engine.execute_groupby_batch`); approximate distinct counts and APPROX_QUANTILE
run as sketch aggregators on the device.  Under `count_distinct_mode =
'exact'` a COUNT(DISTINCT) runs its inner grouping on the device (a
high-cardinality group-by, carried by the engine's tiers) and re-aggregates
on the host (`_execute_exact_distinct`).

A statement the planner cannot rewrite (a subquery, a window, a set
operation, an unconforming join, an expression no transform covers) runs on
the host fallback (`exec/fallback.py`, `_run_fallback`) under
`SessionConfig.fallback_execution`: the same logical plan interpreted over
decoded host frames, with every Aggregate subtree offered to the planner
first (`device_subplan`), so a GROUP BY the planner can rewrite still runs
on the engine where the cost model prices it 3x below the interpreter.
`last_metrics.executor` says which ran: "device", "fallback" or
"device+fallback".  A non-aggregate SELECT plans to a Scan
query, which the engine answers on the device.

`TableQuery` (`ctx.table(name)`) builds the same logical plans through
immutable chaining and runs them as the SQL path does; `register_lookup`
registers the maps `LOOKUP(dim, 'name')` reads; `sql_arrow` returns a
`pyarrow.Table`.  `execute_native_degraded` answers a Druid-native spec on
the host fallback (`exec/wire_fallback.py`) when a caller asks for it by
name.  The module-level `register_table`, `sql`, `table` and `explain` use
one default context, on the card.

Resilience (`resilience.py`): `sql` and `TableQuery.collect` run under the
session's deadline (`query_timeout_ms`) and partial-result collector
(`partial_results`).  A deadline that expires mid-scan answers with the
partials merged so far, the frame's `attrs` carrying {"partial": True,
"coverage": ...}; one that expires outside a partial-capable loop triggers
the collector and runs the rewrite again, every loop now stopping at once
(the drain).  Device execution runs under the device breaker
(`_execute_with_resilience`): an open breaker, or a transient failure that
outlived the engine's retries, answers on the host fallback, stamped
`degraded` and counted, with the device assist declined so a degraded
query never goes back to the sick card.  Static errors (a kernel that does
not build, launch or capture, a sticky CUDA error) surface unchanged.  The
fallback has a breaker of its own.  `sql_progressive` yields refinements of
an aggregate query, one per segment.

Serving and observability (`serve/`, `obs/`, `server.py`): every `sql`,
`TableQuery.collect` and `explain_analyze` runs inside a query trace (the
server's, when it opened one), whose cost receipt is stamped on the
answer (`df.attrs["receipt"]`, `last_metrics.receipt`).  `execute_rewrite`
asks the result cache first (`SessionConfig.result_cache_entries`; a hit
does no device work and is stamped `strategy="result-cache"`), then the
micro-batch fusion scheduler (`fusion_window_ms`), then runs the query
alone, and stores the answer unless a deadline cut it.  An open breaker or
a deadline drain serves a cached complete answer before it degrades or
drains.  `OlapServer(ctx)` serves the context over HTTP.

Ingest and storage (`ingest/`, `storage.py`, `catalog/persist.py`):
`append_rows` publishes delta segments the next query answers from,
`compact` rolls them into historical segments, and under
`SessionConfig.storage_dir` every append is journaled (fsync) before it is
published and the context recovers at construction (snapshots memory-mapped,
WAL tails replayed).  Retired segment uids leave the engine and the
fallback's decode cache at once (`_on_segments_dropped`).  `save_table` and
`load_table` move a datasource through a directory in the JAX package's
format; `start_sys_sampler` feeds the `__sys` datasource; `close` stops
the context's threads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .catalog.cache import MetadataCache
from .catalog.segment import DataSource, build_datasource
from .catalog.star import StarSchemaInfo
from .config import SessionConfig
from .exec.engine import Engine
from .exec.fallback import (
    assist_columns,
    drain_memo,
    evict_decoded_segments,
    execute_fallback,
    plan_input_rows,
    plan_tables,
)
from .exec.finalize import apply_limit_spec
from .exec.lowering import groupby_with_time_granularity
from .exec.metrics import QueryMetrics
from .models import query as Q
from .ops.groupby import SCATTER_CUTOVER
from .obs import (
    SPAN_DEGRADED,
    SPAN_EXECUTE,
    SPAN_FALLBACK,
    SPAN_PARTIAL,
    SPAN_PLAN,
    Tracer,
    current_query_id,
    current_trace,
    prof,
    record_partial,
    record_query_metrics,
    span,
    span_event,
)
from .plan import expr as E
from .plan import logical as L
from .plan.cost import choose_kernel_strategy, query_kernel_costs
from .plan.planner import Planner, Rewrite, RewriteError
from .plan.transforms import RewritePolicyError
from .resilience import (
    CircuitOpenError,
    DeadlineExceeded,
    ResilienceState,
    classify_error,
    current_partial,
    deadline_scope,
    partial_scope,
)
from .sql.parser import parse_sql
from .utils.log import get_logger
from .utils.lru import CountBudgetCache

log = get_logger("api")

__all__ = ["TPUOlapContext", "TableQuery", "RewriteError"]


def _breaker_observation(br) -> dict:
    """The breaker as the routing layer saw it, for the span events of a
    degraded route: which backend's breaker said no, and its state."""
    d = br.to_dict()
    return {
        "backend": d["backend"],
        "state": d["state"],
        "consecutive_failures": d["consecutive_failures"],
        "trips": d["trips"],
    }


class TPUOlapContext:
    """A session: catalog, views, session flags, plan cache and one engine.

    Like `Engine`, it runs on CUDA unless the caller passes a device
    (`device="cpu"` runs on the host); with no device given and no GPU
    present the constructor raises.

    `devices` is the device list of its mesh (`parallel/distributed.py`):
    by default every visible card on a card (one entry on the CPU), so a
    one-card context never plans the mesh.  With more than one entry the
    cost model plans a GroupBy-family query onto the mesh where it prices
    it cheaper (`SET prefer_distributed`, `mesh_data_axis`,
    `mesh_groups_axis`); a list may repeat a device (a logical mesh: 8 x
    "cpu" in the tests, 4 x "cuda:0" on one card)."""

    def __init__(self, config: Optional[SessionConfig] = None, device=None, devices=None):
        self.engine = Engine(device=device)
        if devices is not None:
            self.devices = [torch.device(d) for d in devices]
        elif self.engine.device.type == "cuda":
            self.devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            self.devices = [self.engine.device]
        # the mesh engine, built when a plan first takes the mesh; the
        # engine the last execution ran on (`last_metrics` reads it)
        self._dist_engine = None
        self._last_engine = self.engine
        # the cluster tier (cluster/): a broker's ClusterClient, set by its
        # `attach()` (covered queries then scatter to the historicals), and
        # a historical's node id, which its scatter route stamps
        self.cluster = None
        self.cluster_node_id = ""
        # the cost constants of the engine's device (its calibration file,
        # or on the CPU the CPU profile) unless the caller brings a config
        self.config = config or SessionConfig.load_calibrated(device=self.engine.device)
        self.catalog = MetadataCache()
        # the breakers (device, fallback), the admission and lane pools and
        # the failure counters
        self.resilience = ResilienceState(self.config)
        # per-query span tracing: the ring behind GET
        # /druid/v2/trace/{query_id} (the metrics registry is process-wide)
        self.tracer = Tracer(
            capacity=self.config.trace_ring_capacity,
            otlp_path=self.config.otlp_export_path,
            prof_sample_rate=self.config.prof_sample_rate,
        )
        # the serving core: result cache, micro-batch fusion, lanes
        from .serve import ServingCore

        self.serve = ServingCore(self)
        # streamed ingest (ingest/): appends publish delta segments, and the
        # compactor rolls them into historical ones.  Retired segment uids
        # (a compaction, a dictionary-extension remap) leave the engine's
        # residency, pinned copies and graphs and the fallback's decode
        # cache at once (`_on_segments_dropped`)
        from .ingest import Compactor, IngestManager

        self.ingest = IngestManager(self.catalog, self.config)
        self.ingest.on_segments_dropped = self._on_segments_dropped
        self.compactor = Compactor(
            self.ingest,
            rows_per_segment=self.config.compaction_rows_per_segment,
            min_delta_rows=self.config.compaction_min_delta_rows,
            interval_s=self.config.compaction_interval_s,
            sys_retention_s=self.config.sys_retention_s,
        )
        self.storage = None
        self.sys_sampler = None
        # how the last register_table read its CSV (catalog.ingest.IngestReport)
        self.last_ingest = None
        self.apply_config()
        # SQL text -> (Rewrite, logical plan): a repeated dashboard query
        # pays parse + plan once, and keeps the plan it degrades to.  Keyed
        # on the catalog version, views and config, so any re-registration
        # or session-flag change invalidates.
        self._plan_cache = CountBudgetCache(256)
        # CREATE VIEW registry: view name -> defining SELECT text; the parser
        # expands references as derived tables
        self.views: Dict[str, str] = {}
        # the durable tier (storage.py) under `storage_dir`: the append WAL
        # and crash-safe snapshots.  Recovery runs now, before the context
        # is handed out: a restarted process serves the state it had (the
        # snapshots memory-mapped, the WAL tails replayed) from its first
        # query.  `storage_dir` is read here only
        if self.config.storage_dir:
            from .storage import DurableStorage

            self.storage = DurableStorage(self.config.storage_dir, self.catalog, self.ingest,
                                          fsync=self.config.storage_fsync)
            self.ingest.storage = self.storage
            self.compactor.storage = self.storage
            self.storage.recover(self.resilience)
            if self.config.snapshot_flush_s > 0:
                self.storage.start_flush_sweep(self.config.snapshot_flush_s)
        # the `__sys` telemetry sampler (obs/telemetry.py), built on first
        # start; `sys_sampler_s` > 0 starts its thread now
        if self.config.sys_sampler_s > 0:
            self.start_sys_sampler()
        # (metrics of the last answer that did not come from the engine's
        # own execution, i.e. a host-fallback query, a result-cache hit or
        # a fused batch's member, and the engine's metrics object then):
        # `last_metrics` serves the first while the engine has run nothing
        # since
        self._stamped_metrics = None

    def apply_config(self) -> None:
        """Hands the session's execution flags to the engine (transfer
        pipeline, arena, retry budget), the breaker flags to the breakers,
        the serving flags to the result cache, the fusion scheduler and the
        admission, ingest and lane pools, the tracing flags to the tracer,
        the ingest and storage flags to the compactor, the WALs and the
        sweeps, and the cluster flags to an attached ClusterClient; `SET`
        calls it after every change."""
        cfg = self.config
        self.engine.configure_pipeline(cfg)
        self.engine.cost_config = cfg
        if self._dist_engine is not None:
            self._sync_mesh_engine()
        for br in self.resilience.breakers.values():
            br.failure_threshold = max(1, int(cfg.breaker_failure_threshold))
            br.cooldown_ms = float(cfg.breaker_cooldown_ms)
        self._sync_engine_resilience(self.engine)
        self.resilience.configure(cfg)
        self.serve.configure(cfg)
        self.tracer.sampler.rate = float(cfg.prof_sample_rate)
        self.tracer.ring.capacity = max(1, int(cfg.trace_ring_capacity))
        self.tracer.otlp_path = cfg.otlp_export_path
        self._apply_ingest_config(cfg)
        if self.cluster is not None:
            self.cluster.configure(cfg)

    def _apply_ingest_config(self, cfg) -> None:
        """The ingest and storage flags: the compactor's sizes, period and
        retention, the WALs' fsync, and the flush sweep's and the `__sys`
        sampler's threads (started, re-timed or stopped).  The ingest
        manager reads `delta_seal_rows` from the session config at each
        append; `storage_dir` is read at construction only."""
        c = self.compactor
        c.rows_per_segment = int(cfg.compaction_rows_per_segment)
        c.min_delta_rows = int(cfg.compaction_min_delta_rows)
        c.interval_s = float(cfg.compaction_interval_s)
        c.sys_retention_s = float(cfg.sys_retention_s)
        # a thread starts, re-times or stops only when its own flag changed
        # (a SET of another flag leaves a sampler started by hand running)
        threads = (float(cfg.snapshot_flush_s), float(cfg.sys_sampler_s))
        before, self._thread_flags = getattr(self, "_thread_flags", threads), threads
        if self.storage is not None:
            self.storage.set_fsync(cfg.storage_fsync)
            if threads[0] != before[0]:
                if threads[0] > 0:
                    self.storage.start_flush_sweep(threads[0])
                else:
                    self.storage.stop_flush_sweep()
        if self.sys_sampler is not None:
            self.sys_sampler.max_series = int(cfg.sys_sampler_max_series)
        if threads[1] != before[1]:
            if threads[1] > 0:
                self.start_sys_sampler(threads[1])
                self.sys_sampler.interval_s = max(0.1, threads[1])
            else:
                self.stop_sys_sampler()

    def _stamp_metrics(self, m) -> None:
        """Makes `m` the context's last metrics (a fallback run, a cache
        hit, a fused member)."""
        self._stamped_metrics = (m, self._last_engine.last_metrics)

    # -- registration (CREATE TABLE ... USING ... OPTIONS analog) -----------

    def register_table(
        self,
        name: str,
        source,
        dimensions: Sequence[str] = (),
        metrics: Sequence[str] = (),
        time_column: Optional[str] = None,
        star_schema: Optional[StarSchemaInfo] = None,
        column_mapping: Optional[Mapping[str, str]] = None,
        rows_per_segment: int = 1 << 22,
        dicts: Optional[Mapping] = None,
        sort_by: Sequence[str] = (),
        rollup_granularity: Optional[str] = None,
    ) -> DataSource:
        """Register a datasource from a pandas DataFrame, a dict of numpy
        columns, or a parquet/csv path (catalog/ingest.py).  `dicts` supplies
        pre-built dimension dictionaries for already-encoded columns.

        `sort_by` orders rows by the named columns before segmenting (the
        Druid secondary-partitioning analog): filters on those columns then
        prune whole segments via zone maps instead of masking rows.

        `rollup_granularity` opts the datasource into Druid-style ingest-time
        rollup: appends pre-aggregate under the declared fixed-period
        granularity ("second" .. "week"; a time column is required) before
        they are journaled and published, so count(*) counts rolled rows.

        A CSV path is read by the native decoder, its string columns
        arriving encoded; `last_ingest` (a `catalog.ingest.IngestReport`)
        says which decoder read it and why the native one declined.

        With a durable tier the snapshot commits before the call returns."""
        from .catalog.ingest import IngestReport, to_columns_encoded

        report = IngestReport()
        self.last_ingest = report
        cols, native_dicts = to_columns_encoded(source, report)
        if column_mapping:
            cols = {column_mapping.get(k, k): v for k, v in cols.items()}
            native_dicts = {column_mapping.get(k, k): v for k, v in native_dicts.items()}
        if dicts:
            # caller dictionaries win, by re-encoding the raw values: native
            # codes are ranks over the file's domain, never another's
            for k in [k for k in native_dicts if k in dicts]:
                cols[k] = native_dicts.pop(k).decode(np.asarray(cols[k]))
        if time_column and time_column in native_dicts:
            # a string time column arrived as rank codes: parse each
            # dictionary value once (a value that is no time raises)
            d = native_dicts.pop(time_column)
            codes = np.asarray(cols[time_column])
            if (codes < 0).any():
                raise ValueError(f"time column {time_column!r} has nulls")
            cols[time_column] = np.asarray(
                d.values, dtype="datetime64[ms]").astype(np.int64)[codes]
        if time_column and np.asarray(cols[time_column]).dtype.kind in "OUS":
            # a string time column (CSV): parse each distinct value once
            vals, inv = np.unique(np.asarray(cols[time_column]), return_inverse=True)
            ms = np.asarray(vals, dtype="datetime64[ms]").astype(np.int64)
            cols[time_column] = ms[inv]
        if native_dicts:
            dicts = {**native_dicts, **(dicts or {})}
            if not dimensions and not metrics:
                # encoded string columns are int32 codes now: those with a
                # native dictionary are dimensions
                dims, mets = _infer_schema(cols, time_column)
                dimensions = dims + [m for m in mets if m in native_dicts]
                metrics = [m for m in mets if m not in native_dicts]
        if not dimensions and not metrics:
            dimensions, metrics = _infer_schema(cols, time_column)
        if sort_by:
            missing = [c for c in sort_by if c not in cols]
            if missing:
                raise ValueError(f"sort_by names unknown columns {missing}")

            def sort_keys(c):
                # null-safe keys: nulls order last (the flag is the more
                # significant key, so it follows the value in the lexsort)
                a = np.asarray(cols[c])
                if a.dtype.kind == "O":
                    nulls = np.array([v is None for v in a])
                    vals = np.array([("" if v is None else str(v)) for v in a])
                    return [vals, nulls]
                if c in (dicts or {}) and a.dtype.kind in "iu":
                    # pre-encoded codes: null codes are negative
                    return [a, a < 0]
                return [a]

            # stable lexsort (last key primary); encoded dims sort by code,
            # which is value order (dictionaries are sorted)
            keys: list = []
            for c in reversed(sort_by):
                keys.extend(sort_keys(c))
            order = np.lexsort(tuple(keys))
            cols = {k: np.asarray(v)[order] for k, v in cols.items()}
        ds = build_datasource(
            name,
            cols,
            dimension_cols=list(dimensions),
            metric_cols=list(metrics),
            time_col=time_column,
            rows_per_segment=rows_per_segment,
            dicts=dicts,
        )
        if rollup_granularity is not None:
            from .utils.granularity import granularity_period_ms

            if time_column is None:
                raise ValueError("rollup_granularity requires a time column")
            if granularity_period_ms(rollup_granularity) is None:
                raise ValueError(
                    f"rollup_granularity {rollup_granularity!r} has no fixed period; "
                    "use second/minute/.../week")
            ds = dataclasses.replace(ds, rollup_granularity=str(rollup_granularity).lower())
        return self.register_datasource(ds, star_schema)

    def register_datasource(self, ds: DataSource, star_schema=None):
        """Register an already-built DataSource (a sharded or streamed build,
        one loaded from disk) under its own name; with a durable tier its
        snapshot commits before the call returns."""
        if star_schema is not None and not isinstance(star_schema, StarSchemaInfo):
            star_schema = StarSchemaInfo.from_json(star_schema)
        published = self.catalog.put(ds, star_schema)
        if self.storage is not None:
            self.storage.flush(ds.name)
        return published

    # -- streamed ingest, compaction, persistence ---------------------------

    def append_rows(self, name: str, rows) -> dict:
        """Append streamed rows (a list of row objects or a mapping of
        columns) to a registered datasource, inside an `ingest` trace.  The
        rows are in the next query's answer: they publish as delta
        segments, whose partials merge with the historical ones on the
        device.  With a durable tier the batch is journaled and fsync'd
        before the publish.  Returns the acknowledgement {"appended",
        "datasourceVersion", "totalRows"}."""
        with self.tracer.query_trace(query_type="ingest", slow_ms=self.config.slow_query_ms):
            return self.ingest.append_rows(name, rows)

    def compact(self, name: str) -> dict:
        """Roll `name`'s delta segments into historical segments of
        `compaction_rows_per_segment` rows now (the background sweep does it
        on its period).  The row set and every answer stay the same; the
        version bumps and the retired uids are evicted."""
        with self.tracer.query_trace(query_type="compaction", slow_ms=self.config.slow_query_ms):
            return self.compactor.compact(name)

    def start_compaction(self):
        """Starts the background compaction sweep (a daemon thread)."""
        self.compactor.start()
        return self

    def stop_compaction(self):
        self.compactor.stop()

    def start_sys_sampler(self, interval_s: Optional[float] = None):
        """Starts the `__sys` telemetry sampler's thread: every tick appends
        the metrics registry's readings to the `__sys` datasource
        (obs/telemetry.py).  `sys_sampler.sample_once()` takes one tick
        without a thread."""
        from .obs.telemetry import SysSampler

        if self.sys_sampler is None:
            self.sys_sampler = SysSampler(
                self,
                interval_s=interval_s if interval_s is not None else self.config.sys_sampler_s or 5.0,
                max_series=self.config.sys_sampler_max_series,
            )
        self.sys_sampler.start()
        return self.sys_sampler

    def stop_sys_sampler(self):
        if self.sys_sampler is not None:
            self.sys_sampler.stop()

    def close(self) -> None:
        """Stops the context's threads (the compaction sweep, the `__sys`
        sampler, the snapshot flush sweep) and closes its WAL files.  Data
        stays as published; a durable context loses nothing it
        acknowledged."""
        self.stop_compaction()
        self.stop_sys_sampler()
        if self.storage is not None:
            self.storage.close()

    def _on_segments_dropped(self, uids):
        """Retired segment uids (the ingest tier's, a replaced or dropped
        table's): the engine drops their device columns, pinned host copies
        and graphs, the mesh engine its shards and programs, and the
        fallback its decoded frames."""
        self.engine.evict_segments(uids)
        if self._dist_engine is not None:
            self._dist_engine.evict_segments(uids)
        evict_decoded_segments(uids)

    def save_table(self, name: str, directory: str) -> str:
        """Persist a registered datasource (codes, dictionaries, star
        schema) to a directory in the JAX package's format; `load_table`
        or `CREATE TABLE t USING tpu_olap OPTIONS (path '<dir>')` restores
        it without ingest or encoding."""
        from .catalog.persist import save_datasource

        ds = self.catalog.get(name)
        if ds is None:
            raise KeyError(f"table {name!r} does not exist")
        return save_datasource(ds, directory, self.catalog.star_schema(name))

    def load_table(self, directory: str, name: Optional[str] = None):
        """Register a datasource saved by `save_table` (either package's),
        under `name` or its saved name."""
        from .catalog.persist import load_datasource

        ds, star = load_datasource(directory, name=name)
        # drop first: put() keeps an old star when none is given, and a
        # star-less load over a starred table must not keep it
        old = self.catalog.get(ds.name)
        self.catalog.drop(ds.name)
        if old is not None:
            self._on_segments_dropped(frozenset(s.uid for s in old.segments))
        published = self.catalog.put(ds, star)
        if self.storage is not None:
            self.storage.flush(ds.name)
        return published

    def register_lookup(self, name: str, mapping: Mapping[str, str]):
        """Register a query-time lookup table (Druid lookup extraction):
        `LOOKUP(dim, 'name')` in GROUP BY maps dimension values through it on
        the host, as a dictionary rewrite.  The catalog version moves, so
        cached plans that baked in the old map are planned again."""
        self.catalog.put_lookup(name, dict(mapping))

    def drop_table(self, name: str):
        ds = self.catalog.get(name)
        self.catalog.drop(name)
        if ds is not None:
            self._on_segments_dropped(frozenset(s.uid for s in ds.segments))

    def clear_cache(self):
        """Clear-metadata-cache command: drops the catalog, the device
        residency, the host fallback's decoded segments, the plan cache and
        the result cache."""
        uids = [s.uid for t in self.catalog.tables() for s in self.catalog.get(t).segments]
        self.catalog.clear()
        evict_decoded_segments(uids)
        self.engine.clear_cache()
        if self._dist_engine is not None:
            self._dist_engine.clear_cache()
        self._plan_cache.clear()
        self.serve.result_cache.clear()

    @property
    def last_metrics(self):
        """QueryMetrics of the most recent execution: the host fallback's
        (executor "fallback" or "device+fallback") after a fallback query,
        a result-cache hit's (strategy "result-cache") or a fused member's
        after those, else the engine's."""
        fb = self._stamped_metrics
        last = self._last_engine.last_metrics
        if fb is not None and fb[1] is last:
            return fb[0]
        return last

    # -- planning ------------------------------------------------------------

    def _planner(self) -> Planner:
        return Planner(self.catalog, self.config, device=self.engine.device,
                       n_devices=len(self.devices))

    def _pinned_strategy(self) -> Optional[str]:
        """The engine's strategy when it pins this context's queries (set
        to anything but "auto"), else None."""
        s = self.engine.strategy
        return None if s == "auto" else s

    def strategy_for(self, rw: Rewrite) -> str:
        """The strategy one execution of `rw` runs under: the plan's class
        (`rw.physical.strategy`), unless the engine's strategy pins it.  It
        is passed to the engine per execution and never stored on it.  The
        session's cost constants reach the engine here on every call (the
        adaptive tier's compacted pass prices with them), also after the
        config was replaced."""
        self.engine.cost_config = self.config
        if self._pinned_strategy() is not None or rw.physical is None:
            return self.engine.strategy
        return rw.physical.strategy

    def plan_sql(self, sql_text: str) -> Rewrite:
        lp, _, _ = parse_sql(sql_text, views=self.views)
        return self._planner().plan(lp)

    def explain(self, sql_text: str) -> str:
        """EXPLAIN DRUID REWRITE analog: logical plan -> chosen query spec
        JSON -> the paths this context's engine tries for it."""
        lp, _, _ = parse_sql(sql_text, views=self.views)
        return self._planner().explain(lp, self.engine, self._pinned_strategy())

    def explain_analyze(self, sql_text: str):
        """EXPLAIN ANALYZE analog: runs the query and returns (DataFrame,
        the explain text + the measured QueryMetrics + the span tree).  It
        bypasses the result cache: the metrics describe this execution.  A
        statement the planner cannot rewrite runs on the host fallback and
        its text says so ("== Host Fallback ==")."""
        lp, _, _ = parse_sql(sql_text, views=self.views)
        planner = self._planner()
        # finishing pins the root's duration for the render, but only when
        # this call opened the trace (a joined outer trace runs on)
        owned = current_trace() is None
        with self.tracer.query_trace(
            query_type="explain_analyze", slow_ms=self.config.slow_query_ms
        ) as tr:
            try:
                with span(SPAN_PLAN):
                    rw = planner.plan(lp)
            except RewriteError as err:
                df = self._run_fallback(lp, err)
                text = f"== Host Fallback ==\nrewrite failed: {err}"
            else:
                with span(SPAN_EXECUTE):
                    df = self.execute_rewrite(rw, use_result_cache=False)
                text = planner.explain(lp, self.engine, self._pinned_strategy())
            m = self.last_metrics
            if m is not None:
                text += "\n\n== Execution Metrics ==\n" + m.describe()
            if owned:
                tr.finish()
            return df, text + "\n\n== Span Tree ==\n" + tr.render()

    # -- execution -----------------------------------------------------------

    def _plan_cache_key(self, sql_text: str):
        return (
            sql_text,
            self.catalog.version,
            tuple(sorted(self.views.items())),  # view redefinition invalidates
            repr(self.config),
            len(self.devices),
        )

    def plan_cached(self, sql_text: str) -> Rewrite:
        """The Rewrite for a SELECT, from the plan cache when the same text
        was planned against the same catalog, views and config."""
        key = self._plan_cache_key(sql_text)
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached[0]
        lp, _, _ = parse_sql(sql_text, views=self.views)
        rw = self._planner().plan(lp)
        self._plan_cache[key] = (rw, lp)
        return rw

    @contextlib.contextmanager
    def _query_scope(self):
        """The session's deadline and partial-result collector around one
        query (an outer scope already armed wins)."""
        with deadline_scope(self.config.query_timeout_ms), partial_scope(
            self.config.partial_results
        ):
            yield

    def sql(self, sql_text: str):
        """Run one SQL statement and return a pandas DataFrame.  Commands
        (CREATE/DROP/SHOW/DESCRIBE/SET/CLEAR CACHE) dispatch first."""
        from .sql.commands import parse_command, run_command

        cmd = parse_command(sql_text)
        if cmd is not None:
            return run_command(self, cmd)
        # the trace joins the server's when one is active (the outermost
        # scope wins, as for the deadline); a direct call gets its own id
        with self.tracer.query_trace(
            query_type="sql", slow_ms=self.config.slow_query_ms
        ), self._query_scope():
            plan_err = None
            with span(SPAN_PLAN):
                key = self._plan_cache_key(sql_text)
                cached = self._plan_cache.get(key)
                if cached is not None:
                    rw, lp = cached
                else:
                    lp, explain, _ = parse_sql(sql_text, views=self.views)
                    planner = self._planner()
                    if explain:
                        import pandas as pd

                        text = planner.explain(lp, self.engine, self._pinned_strategy())
                        return pd.DataFrame({"plan": text.split("\n")})
                    try:
                        rw = planner.plan(lp)
                    except RewriteError as err:
                        rw, plan_err = None, err
                    else:
                        self._plan_cache[key] = (rw, lp)
            return self._answer(rw, lp, plan_err)

    def _answer(self, rw: Optional[Rewrite], lp, plan_err=None):
        """A planned statement's answer: on the host fallback when the
        planner could not rewrite it, else under the device breaker; stamped
        partial when a deadline cut it short, and with its cost receipt
        (outside the execute span, so the receipt sees it closed)."""
        if rw is None:
            return self._stamp_receipt(self._stamp_partial(self._run_fallback(lp, plan_err)))
        with span(SPAN_EXECUTE):
            df = self._stamp_partial(self._execute_with_resilience(rw, lp))
        return self._stamp_receipt(df)

    def sql_progressive(self, sql_text: str):
        """Progressive execution of one SQL statement: a generator of
        `(df, info)` refinements, one per in-scope segment, converging to
        the exact answer (`Engine.execute_progressive`); each passes through
        the host post-processing `sql` applies, so the last frame is
        `sql`'s answer.  None when the statement cannot stream (a command,
        EXPLAIN, a fallback shape, grouping sets, an exact COUNT(DISTINCT),
        a query type other than GroupBy, Timeseries and TopN, a plan on the
        mesh, or an open device breaker: the buffered path then degrades
        properly); the caller then answers with `sql`."""
        from .sql.commands import parse_command

        if parse_command(sql_text) is not None:
            return None
        key = self._plan_cache_key(sql_text)
        cached = self._plan_cache.get(key)
        if cached is not None:
            rw = cached[0]
        else:
            lp, explain, _ = parse_sql(sql_text, views=self.views)
            if explain:
                return None
            try:
                rw = self._planner().plan(lp)
            except RewriteError:
                return None
            self._plan_cache[key] = (rw, lp)
        if rw.exact_distinct is not None or rw.grouping_sets:
            return None
        q = rw.query
        if not isinstance(q, (Q.GroupByQuery, Q.TimeseriesQuery, Q.TopNQuery)):
            return None
        if isinstance(q, Q.GroupByQuery) and q.subtotals:
            return None
        if self._backend_for(rw) == "mesh":
            return None  # the mesh has no per-segment refinement
        if not self.resilience.breaker_for("device").allow():
            return None
        ds = self.catalog.get(rw.datasource)
        if ds is None:
            return None
        strategy = self.strategy_for(rw)

        def refinements():
            with self._query_scope():
                for df, info in self.engine.execute_progressive(q, ds, strategy):
                    yield self._post_process(rw, ds, df), info

        return refinements()

    # -- resilience ------------------------------------------------------------

    def _sync_engine_resilience(self, engine, backend: str = "device") -> None:
        """Points an engine at this context's breaker for `backend` and the
        session's retry budget."""
        engine.breaker = self.resilience.breaker_for(backend)
        engine._retry_attempts = self.config.retry_max_attempts
        engine._retry_backoff_ms = self.config.retry_backoff_ms

    def _backend_for(self, rw: Rewrite) -> str:
        """The backend a rewrite runs on: "mesh" when its plan took the mesh
        and the context's device list fills the planned shape, else
        "device".  `_engine_for` branches on it, so the breaker that gates a
        query and the engine that runs it never disagree."""
        phys = rw.physical
        if phys is not None and phys.distributed and phys.mesh_shape is not None:
            if len(self.devices) >= phys.mesh_shape[0] * phys.mesh_shape[1]:
                return "mesh"
        return "device"

    def _engine_for(self, rw: Rewrite):
        """The engine that runs `rw`: the mesh engine (built on first use over
        the context's device list at the planned shape, kept while the
        shape stays) under the "mesh" breaker, synced to the session's
        constants and flags; else the single-device engine."""
        if self._backend_for(rw) != "mesh":
            self._last_engine = self.engine
            return self.engine
        from .parallel.distributed import DistributedEngine
        from .parallel.mesh import make_mesh

        nd, ng = rw.physical.mesh_shape
        eng = self._dist_engine
        if eng is None or (eng.mesh.shape["data"], eng.mesh.shape["groups"]) != (nd, ng):
            if eng is not None:
                eng.clear_cache()
            self._dist_engine = DistributedEngine(make_mesh(nd, ng, devices=self.devices))
        self._sync_mesh_engine()
        self._last_engine = self._dist_engine
        return self._dist_engine

    def _sync_mesh_engine(self) -> None:
        """The session's constants, arena flag, breaker and retry budget on
        the mesh engine."""
        eng = self._dist_engine
        eng.cost_config = self.config
        eng.configure_pipeline(self.config)
        self._sync_engine_resilience(eng, "mesh")

    def _execute_with_resilience(self, rw: Rewrite, lp):
        """Device execution under the backend's breaker.  An open breaker,
        or a transient failure that outlived the engine's retries, answers
        on the host fallback (stamped degraded, the assist declined), unless
        the result cache holds the complete answer.  A deadline expiry
        outside a partial-capable loop serves a cached complete answer, or
        triggers the collector and drains with a second run; without a
        collector it raises, counted.  Static errors surface unchanged."""
        res = self.resilience
        backend = self._backend_for(rw)
        br = res.breaker_for(backend)
        can_degrade = lp is not None and self.config.fallback_execution
        if can_degrade and not br.allow():
            # an open circuit must not cost a cached answer: the cache holds
            # complete frames that need no device work
            hit = self._cached_result(rw)
            if hit is not None:
                return hit
            log.warning("%s circuit open; answering on the host fallback", backend)
            with span(SPAN_DEGRADED, reason="circuit_open"):
                # the breaker state seen at routing time: the trace shows
                # why the fallback answered
                span_event("breaker_state", **_breaker_observation(br))
                df = self._run_fallback(lp, None, reason=f"{backend} circuit open",
                                        assist_declined=f"assist: {backend} breaker open")
            self._stamp_degraded(None, backend=backend)
            return df
        try:
            df = self.execute_rewrite(rw)
        except Exception as err:
            kind = classify_error(err)
            if kind == "deadline":
                pc = current_partial()
                if pc is not None:
                    # a complete cached answer (an identical query finished
                    # meanwhile) beats any partial one
                    hit = self._cached_result(rw)
                    if hit is not None:
                        return hit
                    pc.trigger(getattr(err, "site", "") or "deadline")
                    log.warning("deadline expired outside a partial-capable loop (%s); "
                                "draining a best-effort answer", err)
                    return self.execute_rewrite(rw)
                res.note_deadline_exceeded()
                m = self.last_metrics
                if m is not None:
                    m.deadline_exceeded = True
                raise
            if kind != "transient" or not can_degrade:
                raise
            log.warning("%s execution failed (%s: %s) after retries; degrading to the "
                        "host fallback", backend, type(err).__name__, err)
            with span(SPAN_DEGRADED, reason="device_failed"):
                span_event("breaker_state", error_class=type(err).__name__,
                           **_breaker_observation(br))
                df = self._run_fallback(lp, err, reason=f"{backend} execution failed",
                                        assist_declined=f"assist: {backend} failed")
            self._stamp_degraded(err, backend=backend)
            return df
        m = self.last_metrics
        # a cache hit never touched the device: it hands back a half-open
        # probe's lease without a verdict
        if m is not None and m.strategy == "result-cache":
            br.release_probe()
        else:
            br.record_success()
        if m is not None and not m.circuit_state:
            m.circuit_state = br.state
        return df

    def _stamp_degraded(self, err, backend: str = "device") -> None:
        """Marks the (fallback) metrics of a degraded answer and counts it."""
        self.resilience.note_degraded()
        m = self.last_metrics
        if m is not None:
            m.degraded = True
            m.circuit_state = self.resilience.breaker_for(backend).state
            if err is not None:
                m.error_class = type(err).__name__

    def _stamp_partial(self, df):
        """Stamps a deadline-bounded partial answer: the frame's `attrs`
        gain the collector's {"partial": True, "coverage": ..., ...}, the
        metrics `partial`, `coverage` and `rows_seen`, and the trace a
        `partial` span (with `sdol_partial_results_total` and the coverage
        histogram).  A no-op for a complete answer, and for a cached one:
        the collector then describes an aborted execution, not the frame."""
        pc = current_partial()
        if pc is None or not pc.is_partial:
            return df
        m = self.last_metrics
        if m is not None and m.strategy == "result-cache":
            return df
        info = pc.to_dict()
        with span(SPAN_PARTIAL, coverage=info["coverage"], site=info["site"],
                  rows_seen=info["rows_seen"], rows_total=info["rows_total"]):
            record_partial(info["coverage"], site=info["site"] or "",
                           query_id=current_query_id())
        if m is not None:
            m.partial = True
            m.coverage = info["coverage"]
            m.rows_seen = info["rows_seen"]
            m.delta_rows_seen = info["delta_rows_seen"]
        df.attrs.update(info)
        return df

    def _stamp_receipt(self, df):
        """Stamps the query's cost receipt (`obs/prof.py`) on the answer:
        `df.attrs["receipt"]` and `QueryMetrics.receipt` (with its `lane`),
        the live snapshot; the trace document gets the final one at trace
        close.  A no-op outside a trace."""
        rc = prof.live_receipt()
        if rc is None:
            return df
        m = self.last_metrics
        if m is not None:
            m.receipt = rc
            m.lane = rc.get("lane", "") or m.lane
        df.attrs["receipt"] = rc
        return df

    def sql_arrow(self, sql_text: str):
        """`sql()` with the result as a `pyarrow.Table`: NULLs in dimension
        columns become Arrow nulls; NaN metrics stay floating-point NaN."""
        return _to_arrow(self.sql(sql_text))

    def table(self, name: str) -> "TableQuery":
        return TableQuery(self, name)

    def execute_native_degraded(self, q: Q.QuerySpec, err=None,
                                reason: str = "native degradation", backend: str = "device"):
        """Answer a Druid-native spec on the host fallback, degraded: the
        spec decodes to a logical plan (`exec/wire_fallback.native_to_logical`),
        runs through `_run_fallback` as SQL does (the same flags and the
        fallback breaker gate it, the device assist declined), is stamped
        degraded (and partial, under a deadline) and is shaped as the device
        path shapes it.  Raises WireFallbackUnsupported for specs outside
        the interpreter's coverage."""
        from .exec.wire_fallback import native_to_logical, shape_native_result

        ds = self.catalog.get(q.datasource)
        if ds is None:
            raise RewriteError(f"unknown table {q.datasource!r}")
        lp = native_to_logical(q, ds)
        with span(SPAN_DEGRADED, reason="native_" + reason):
            span_event("breaker_state",
                       **_breaker_observation(self.resilience.breaker_for(backend)))
            df = self._run_fallback(lp, err, reason=reason,
                                    assist_declined=f"assist: {reason}")
        self._stamp_degraded(err, backend=backend)
        return shape_native_result(q, ds, self._stamp_receipt(self._stamp_partial(df)))

    def _run_fallback(self, lp, err, reason: str = "rewrite failed",
                      assist_declined: Optional[str] = None):
        """Run a plan on the host fallback: one the planner could not
        rewrite, or a degraded query (`reason` says which).  A policy
        rejection (RewritePolicyError) and a disabled fallback re-raise
        `err` (a RewriteError when `err` is None).  Above
        `fallback_max_rows` input rows the fallback raises
        FallbackSizeError.  The fallback breaker: transient failures count
        on it, and while it is open the fallback fails fast.
        `assist_declined`, set on a degraded route, declines every device
        assist with that reason, as does an open device breaker.  A
        deadline that expires at an interpreter checkpoint under a collector
        triggers it and runs the plan again (the drain), over the decode
        cache and the subqueries the first run answered (`drain_memo`)."""
        if isinstance(err, RewritePolicyError):
            raise err
        if not self.config.fallback_execution:
            raise err if err is not None else RewriteError("fallback execution is disabled")
        fb = self.resilience.breaker_for("fallback")
        if not fb.allow():
            log.warning("host-fallback circuit open; failing fast (%s)", reason)
            if err is not None:
                raise err
            raise CircuitOpenError(
                "host-fallback circuit open and no healthier backend remains; "
                "retry after the breaker's cooldown")
        log.warning("%s (%s); executing on the host fallback", reason, err)
        t0 = time.perf_counter()
        assists = 0
        declines: List[str] = []
        cfg = self.config

        def device_subplan(sub_lp):
            """The device assist: an Aggregate subtree that the planner
            rewrites runs on the engine.  It declines, recording why, when
            the subtree's input is under `device_assist_min_rows`, when the
            planner raises RewriteError, when the rewrite is not a GroupBy
            (or is an exact COUNT(DISTINCT)) over fewer than
            max(device_assist_min_rows, 2^23) rows unless
            `device_assist_force`, when the cost model prices the engine
            no 3x better than the interpreter (`_assist_cost_decline`;
            `device_assist_force` skips it), and when the frame lacks a
            column the node declares.  Any other error, of the planner, the
            engine or the kernel, propagates."""
            nonlocal assists
            if assist_declined is None and self.resilience.breaker.state == "open":
                declines.append("assist: device breaker open")
                return None
            if assist_declined is not None:
                declines.append(assist_declined)
                return None
            rows = plan_input_rows(sub_lp, self.catalog)
            if rows < cfg.device_assist_min_rows:
                declines.append(
                    f"assist: {rows} input rows < device_assist_min_rows "
                    f"{cfg.device_assist_min_rows}")
                return None
            try:
                rw = self._planner().plan(sub_lp)
            except RewriteError as e:
                declines.append(f"assist: {e}")
                return None
            floor = max(cfg.device_assist_min_rows, 1 << 23)
            kind = ("exact COUNT(DISTINCT)" if rw.exact_distinct is not None
                    else type(rw.query).__name__)
            if kind != "GroupByQuery" and rows < floor and not cfg.device_assist_force:
                declines.append(f"assist: {kind} over {rows} rows < {floor}")
                return None
            if kind == "GroupByQuery" and not cfg.device_assist_force:
                why = self._assist_cost_decline(rw, rows)
                if why is not None:
                    declines.append(why)
                    return None
            # a column the node declares that the rewrite does not output
            # (the hidden aggregate of a HAVING) is known before running it
            spec = rw.exact_distinct or rw
            missing = [c for c in assist_columns(sub_lp) if c not in spec.output_columns]
            if not missing:
                out = self.execute_rewrite(rw)
                missing = [c for c in assist_columns(sub_lp) if c not in out.columns]
            if missing:
                declines.append(f"assist: the rewrite's frame lacks {missing}")
                return None
            assists += 1
            return out

        def run(why):
            with span(SPAN_FALLBACK, reason=why):
                return execute_fallback(lp, self.catalog, max_rows=cfg.fallback_max_rows,
                                        device_exec=device_subplan)

        pc = current_partial()
        if pc is not None:
            # the interpreter owns one pass across every table it decodes;
            # its assists must not reset it
            pc.begin_pass()
            pc.in_fallback = True
        # under a collector a drain takes the subqueries its first run answered
        with drain_memo() if pc is not None else contextlib.nullcontext():
            try:
                df = run(reason)
            except DeadlineExceeded as dl_err:
                # expiry at an interpreter checkpoint (the decode's is
                # absorbed in place): drain with a second run, every
                # checkpoint now a no-op, its own accounting the truth about
                # what it saw
                if pc is None:
                    raise
                pc.trigger(dl_err.site or "fallback.interp")
                pc.reset_for_drain()
                df = run("deadline_drain")
                fb.record_success()
            except Exception as fb_err:
                # a static plan or shape gap is the query's, not the backend's
                if classify_error(fb_err) == "transient":
                    fb.record_failure()
                raise
            else:
                fb.record_success()
            finally:
                if pc is not None:
                    pc.in_fallback = False
        tables = sorted(plan_tables(lp))
        m = QueryMetrics(
            query_type="fallback",
            strategy="host-pandas",
            executor="device+fallback" if assists else "fallback",
            datasource=tables[0] if len(tables) == 1 else "",
            query_id=current_query_id(),
            rows_scanned=plan_input_rows(lp, self.catalog),
            total_ms=(time.perf_counter() - t0) * 1e3,
            assist_subplans=assists,
            declines=declines,
        )
        if pc is not None and pc.is_partial:
            m.partial = True
            m.coverage = pc.coverage()
            m.rows_seen = pc.rows_seen
            m.delta_rows_seen = pc.delta_rows_seen
        self._stamp_metrics(m)
        # the host interpreter publishes into the process registry as the
        # engine does
        record_query_metrics(m, "partial" if m.partial else "ok")
        return df

    def _assist_cost_decline(self, rw: Rewrite, rows: int) -> Optional[str]:
        """The calibrated assist decision for a GroupBy subtree over `rows`
        input rows: None to assist, else the decline with its modelled
        figures.  The engine side is the cheapest kernel class at the
        subtree's G (`plan/cost.query_kernel_costs`), one dispatch, a third
        of the copy of its columns not resident on the card (the residency
        keeps them for the repeats this workload makes), and the host's
        decode of each result group; it must beat one pandas pass over the
        rows (`cost_per_row_interp`) 3x over."""
        cfg = self.config
        ds = self.catalog.get(rw.datasource)
        lowering = self.engine._lowering_for(groupby_with_time_granularity(rw.query), ds)
        G = lowering.num_groups
        kernel_us = min(query_kernel_costs(rw.query, ds, G, cfg,
                                           device=self.engine.device).values())
        h2d_us = self.engine.missing_resident_bytes(ds, lowering.columns) / cfg.h2d_bytes_per_s * 1e6
        assist_us = kernel_us + cfg.cost_dispatch_us + h2d_us / 3.0 + G * cfg.cost_per_group_decode
        interp_us = rows * cfg.cost_per_row_interp
        if assist_us * 3 < interp_us:
            return None
        return (f"assist: modelled engine {assist_us:.6g} us x 3 >= interpreter "
                f"{interp_us:.6g} us (G={G}, kernel {kernel_us:.6g} us, h2d {h2d_us:.6g} us, "
                f"{rows} rows)")

    def _result_key(self, rw: Rewrite, ds=None):
        """Result-cache key of a rewrite, or None when it is not cacheable
        (an unknown table, an exact COUNT(DISTINCT)'s outer shape).  It
        leaves out the segment uids and the datasource version (entries
        carry the version they were computed at) and keeps the dictionary
        signature."""
        if rw.exact_distinct is not None:
            return None
        ds = ds or self.catalog.get(rw.datasource)
        if ds is None:
            return None
        from .exec.lowering import _dict_signature

        return (
            rw.to_json(),
            ds.name,
            _dict_signature(ds),
            repr(rw.output_columns),
            repr(rw.grouping_sets),
            repr(rw.host_post_exprs),
            repr(rw.residual_having),
            repr(self.config),
        )

    def _cached_result(self, rw: Rewrite):
        """A complete result-cache answer for `rw` at its datasource's
        version, or None (the degraded and partial routes: no miss counted,
        no delta refresh).  The serving core stamps the hit's metrics as
        the context's last."""
        if self.config.result_cache_entries <= 0:
            return None
        ds = self.catalog.get(rw.datasource)
        if ds is None:
            return None
        return self.serve.cached_result(rw, ds, self._result_key(rw, ds))

    def _fusable(self, rw: Rewrite, ds, strategy: str) -> bool:
        """May this rewrite ride micro-batch fusion under `strategy`?
        GroupBy-family, no grouping sets (they batch already) and the
        executing engine's own gate."""
        if rw.grouping_sets or rw.exact_distinct is not None:
            return False
        if not isinstance(rw.query, (Q.GroupByQuery, Q.TimeseriesQuery, Q.TopNQuery)):
            return False
        return self._engine_for(rw).fusable(rw.query, ds, strategy)

    def execute_rewrite(self, rw: Rewrite, use_result_cache: bool = True):
        """A rewrite's answer: from the result cache, else a fused
        micro-batch, else the engine alone (grouping sets batched), under
        the plan's strategy (`strategy_for`), then the host
        post-processing; a complete answer is stored in the cache."""
        if rw.exact_distinct is not None:
            return self._execute_exact_distinct(rw.exact_distinct, use_result_cache)
        ds = self.catalog.get(rw.datasource)
        if ds is None:
            raise RewriteError(f"unknown table {rw.datasource!r}")
        rkey = None
        if use_result_cache and self.config.result_cache_entries > 0:
            rkey = self._result_key(rw, ds)
        strategy = self.strategy_for(rw)
        engine = self._engine_for(rw)
        execute = None
        if rw.grouping_sets and isinstance(rw.query, Q.GroupByQuery):
            # every set under the plan's class, resolved at the set's own G
            # (a narrow set under a planned scatter priced again there)
            planned = self.config if self._pinned_strategy() is None else None

            def execute():
                return execute_grouping_sets(rw.query, rw.grouping_sets, ds, engine,
                                             strategy=strategy, cfg=planned)
        return self.serve.answer(rw.query, ds, rkey, self._fusable(rw, ds, strategy),
                                 post=lambda df: self._post_process(rw, ds, df),
                                 execute=execute, strategy=strategy, engine=engine)

    def _execute_exact_distinct(self, spec, use_result_cache: bool = True):
        """Two-phase exact COUNT(DISTINCT): the inner rewrite (grouped by the
        dimensions and the distinct columns) on the device, then the
        re-aggregation on the host, where a distinct output counts the
        unique non-null values of its column."""
        import pandas as pd

        inner = self.execute_rewrite(spec.inner, use_result_cache)
        agg_kwargs = {
            name: pd.NamedAgg(column=name, aggfunc=op) for name, op in spec.outer_ops
        }
        for out, col in spec.distinct_outs:
            # nunique skips None/NaN: SQL COUNT(DISTINCT) semantics
            agg_kwargs[out] = pd.NamedAgg(column=col, aggfunc="nunique")
        if spec.dim_names:
            df = inner.groupby(list(spec.dim_names), as_index=False, dropna=False).agg(
                **agg_kwargs
            )
        else:
            df = pd.DataFrame({
                name: [getattr(inner[a.column], a.aggfunc)()]
                for name, a in agg_kwargs.items()
            })
        for c in spec.count_like:
            if c in df:
                df[c] = df[c].astype(np.int64)
        for out, _ in spec.distinct_outs:
            df[out] = df[out].astype(np.int64)
        for name, s, c in spec.avg_div:
            with np.errstate(divide="ignore", invalid="ignore"):
                df[name] = np.where(df[c] != 0, df[s] / np.where(df[c] == 0, 1, df[c]), np.nan)
        for name, e in spec.post_exprs:
            df[name] = _eval_host(e, df)
        if spec.having is not None:
            mask = np.asarray(_eval_host(spec.having, df), dtype=bool)
            df = df[mask].reset_index(drop=True)
        if spec.sort_keys:
            df = df.sort_values(
                [c for c, _ in spec.sort_keys],
                ascending=[a for _, a in spec.sort_keys],
                kind="stable",
            )
        if spec.offset:
            df = df.iloc[spec.offset:]
        if spec.limit is not None:
            df = df.head(spec.limit)
        cols = [c for c in spec.output_columns if c in df.columns]
        return df[cols].reset_index(drop=True)

    def _post_process(self, rw: Rewrite, ds, df):
        """Host-side result shaping every engine answer passes through."""
        # FD grouping pruning: decode the hidden max-over-codes carriers
        # back into the pruned columns before residuals and projection
        for out_name, hidden, dim_col in rw.fd_restores:
            raw = np.asarray(df[hidden], dtype=np.float64)
            codes = np.where(np.isnan(raw), -1, raw).astype(np.int64)
            # decode the result rows only: DimensionDict.decode converts the
            # whole dictionary first (150K customer names at TPC-H SF1)
            values = ds.dicts[dim_col].values
            df[out_name] = np.array(
                [values[c] if c >= 0 else None for c in codes], dtype=object
            )
            df = df.drop(columns=[hidden])
        for name, e in rw.host_post_exprs:
            df[name] = _eval_host(e, df)
        if rw.residual_having is not None:
            mask = np.asarray(_eval_host(rw.residual_having, df), dtype=bool)
            df = df[mask].reset_index(drop=True)
        cols = [c for c in rw.output_columns if c in df.columns]
        if cols and "__grouping_id" in df.columns and "__grouping_id" not in cols:
            cols.append("__grouping_id")  # the grouping sets' GROUPING_ID
        if cols and cols != list(df.columns):  # a pandas selection copies
            df = df[cols]
        return df


def grouping_set_queries(q: Q.GroupByQuery, grouping_sets) -> List[Q.GroupByQuery]:
    """The GroupBy spec each grouping set runs: the set's dimensions, no
    subtotals, and no limit (it applies to the combined result)."""
    return [
        dataclasses.replace(
            q,
            dimensions=tuple(q.dimensions[i] for i in s),
            subtotals=(),
            limit_spec=None,
        )
        for s in grouping_sets
    ]


def execute_grouping_sets(q: Q.GroupByQuery, grouping_sets, ds, engine,
                          strategy: Optional[str] = None,
                          cfg: Optional[SessionConfig] = None):
    """CUBE/ROLLUP/GROUPING SETS: one engine pass per set, all dispatched
    before any is fetched (`Engine.execute_groupby_batch`), absent
    dimensions emitted as nulls, plus a __grouping_id bitmask (SQL
    GROUPING_ID semantics: bit i set => dim i aggregated away).  The
    limit/order spec applies to the combined result, not per set: a per-set
    sort would fail on sets that drop the orderBy dimension.  Under a
    partial collector each set's pass is accounted under its own label, so
    the coverage describes every set (the collector's `sets` name the ones
    a deadline truncated).  Every set runs under `strategy` (None: the
    engine's), but where `strategy` is a plan's scatter class, priced by
    `cfg` at the whole query's G: a set of at most SCATTER_CUTOVER groups is
    priced again at its own G (`choose_kernel_strategy`), so that on a card
    the kernel, not float32 `index_add_`, adds up a narrow set's many rows
    a group."""
    import pandas as pd

    all_dims = q.dimensions
    k = len(all_dims)
    frames = []
    pc = current_partial()
    set_labels = None
    if pc is not None:
        pc.arm_set_collection()
        set_labels = [",".join(all_dims[i].name for i in s) or "()" for s in grouping_sets]
    queries = grouping_set_queries(q, grouping_sets)
    strategies = [strategy] * len(queries)
    if cfg is not None and strategy == "segment":
        for i, sq in enumerate(queries):
            G = engine._lowering_for(groupby_with_time_granularity(sq), ds).num_groups
            if G <= SCATTER_CUTOVER:
                strategies[i] = choose_kernel_strategy(ds.num_rows, G, cfg, device=engine.device)
    results = engine.execute_groupby_batch(queries, ds, set_labels=set_labels,
                                           strategies=strategies)
    if pc is not None:
        pc.finish_sets()
    for s, f in zip(grouping_sets, results):
        gid = 0
        present = set(s)
        for i in range(k):
            if i not in present:
                gid |= 1 << (k - 1 - i)
                f[all_dims[i].name] = None
        f["__grouping_id"] = gid
        frames.append(f)
    df = pd.concat(frames, ignore_index=True)
    order = [d.name for d in all_dims]
    df = df[order + [c for c in df.columns if c not in order]]
    if q.limit_spec is not None:
        df = apply_limit_spec(df, q.limit_spec).reset_index(drop=True)
    return df


def _eval_host(e: E.Expr, df) -> np.ndarray:
    """Evaluate a residual expression over the result table on the host:
    tiny data, numpy semantics, decoded strings."""
    cols = {c: np.asarray(df[c]) for c in df.columns}
    return np.asarray(E.compile_host_expr(e)(cols))


def _infer_schema(cols, time_column):
    dims, mets = [], []
    for k, v in cols.items():
        if k == time_column:
            continue
        if np.asarray(v).dtype.kind in ("U", "S", "O"):
            dims.append(k)
        else:
            mets.append(k)
    return dims, mets


def _to_arrow(df):
    import pyarrow as pa

    return pa.Table.from_pandas(df, preserve_index=False)


class TableQuery:
    """DataFrame-style query builder over the same planner, the analog of
    driving Spark DataFrames instead of SQL.  Every method returns a new
    TableQuery (immutable chaining); `collect()` plans, runs on the engine,
    and answers on the host fallback where the planner cannot rewrite the
    plan, as the SQL path does."""

    def __init__(self, ctx: TPUOlapContext, table: str):
        self.ctx = ctx
        self._table = table
        self._filter: Optional[E.Expr] = None
        self._select: List[Tuple[str, E.Expr]] = []
        self._groups: List[Tuple[str, E.Expr]] = []
        self._aggs: List[L.AggExpr] = []
        self._having: Optional[E.Expr] = None
        self._sort: List[L.SortKey] = []
        self._limit: Optional[int] = None
        self._offset: int = 0

    def _copy(self) -> "TableQuery":
        out = TableQuery(self.ctx, self._table)
        out.__dict__.update(self.__dict__)
        for k in ("_select", "_groups", "_aggs", "_sort"):
            setattr(out, k, list(getattr(self, k)))
        return out

    @staticmethod
    def _as_expr(x) -> E.Expr:
        return E.Col(x) if isinstance(x, str) else x

    def filter(self, e: E.Expr) -> "TableQuery":
        out = self._copy()
        out._filter = e if out._filter is None else E.BoolOp("and", (out._filter, e))
        return out

    where = filter  # the Spark and SQL spelling

    def select(self, *exprs, **named) -> "TableQuery":
        """Projection of a non-aggregate query: select("a", "b") or
        select(rev=E.Col("price") * E.Col("qty"))."""
        out = self._copy()
        out._select += _named_exprs(exprs, named)
        return out

    def group_by(self, *exprs, **named) -> "TableQuery":
        out = self._copy()
        out._groups += _named_exprs(exprs, named)
        return out

    def agg(self, **named) -> "TableQuery":
        """agg(total=("sum", "revenue"), n=("count", None), ...); the
        argument may be a column name or an Expr (a sum over an
        expression)."""
        out = self._copy()
        for name, spec in named.items():
            fn, arg = spec if isinstance(spec, tuple) else (spec, None)
            out._aggs.append(L.AggExpr(name, fn, self._as_expr(arg) if arg is not None else None))
        return out

    def having(self, e: E.Expr) -> "TableQuery":
        """A filter over aggregate outputs, named by their `agg(...)` names
        (E.AggRef, or E.Col of the output name)."""
        out = self._copy()
        out._having = e if out._having is None else E.BoolOp("and", (out._having, e))
        return out

    def order_by(self, key, ascending: bool = True) -> "TableQuery":
        out = self._copy()
        out._sort.append(L.SortKey(self._as_expr(key), ascending))
        return out

    def limit(self, n: int, offset: int = 0) -> "TableQuery":
        out = self._copy()
        out._limit, out._offset = n, offset
        return out

    def _logical(self) -> L.LogicalPlan:
        base: L.LogicalPlan = L.Scan(self._table)
        if self._filter is not None:
            base = L.Filter(self._filter, base)
        if self._groups or self._aggs:
            if self._select:
                raise ValueError(
                    "select() is for non-aggregate queries; grouped "
                    "outputs are named by group_by()/agg()")
            post = tuple((n, E.Col(n)) for n, _ in self._groups) + tuple(
                (a.name, E.AggRef(a.name)) for a in self._aggs)
            plan: L.LogicalPlan = L.Aggregate(
                tuple(self._groups), tuple(self._aggs), base, post_exprs=post)
            if self._having is not None:
                plan = L.Having(_col_to_aggref(self._having, self._aggs), plan)
        else:
            if self._having is not None:
                raise ValueError("having() requires group_by()/agg()")
            plan = L.Project(tuple(self._select), base) if self._select else base
        if self._sort:
            plan = L.Sort(tuple(
                L.SortKey(_col_to_aggref(k.expr, self._aggs), k.ascending)
                for k in self._sort), plan)
        if self._limit is not None:
            plan = L.Limit(self._limit, plan, self._offset)
        return plan

    def collect(self):
        lp = self._logical()
        with self.ctx.tracer.query_trace(
            query_type="dataframe", slow_ms=self.ctx.config.slow_query_ms
        ), self.ctx._query_scope():
            with span(SPAN_PLAN):
                try:
                    rw, plan_err = self.ctx._planner().plan(lp), None
                except RewriteError as err:
                    rw, plan_err = None, err
            return self.ctx._answer(rw, lp, plan_err)

    def collect_arrow(self):
        """`collect()` as a `pyarrow.Table`."""
        return _to_arrow(self.collect())

    def explain(self) -> str:
        return self.ctx._planner().explain(self._logical(), self.ctx.engine)


def _named_exprs(exprs, named) -> List[Tuple[str, E.Expr]]:
    """(name, Expr) pairs of positional column names or Exprs (an Expr is
    named by its text) and keyword-named ones."""
    out = [(x if isinstance(x, str) else str(x), TableQuery._as_expr(x)) for x in exprs]
    return out + [(name, TableQuery._as_expr(x)) for name, x in named.items()]


def _col_to_aggref(e: E.Expr, aggs) -> E.Expr:
    """In HAVING and ORDER BY over a grouped TableQuery, a Col naming an
    aggregate output means the aggregate (SQL alias semantics)."""
    names = {a.name for a in aggs}
    return E.map_expr(
        e, lambda x: E.AggRef(x.name) if isinstance(x, E.Col) and x.name in names else x)


# the module-level default context (the implicit SQLContext analog); it
# runs on the card
_default_ctx: Optional[TPUOlapContext] = None


def default_context() -> TPUOlapContext:
    global _default_ctx
    if _default_ctx is None:
        _default_ctx = TPUOlapContext()
    return _default_ctx


def register_table(*a, **kw):
    return default_context().register_table(*a, **kw)


def sql(text: str):
    return default_context().sql(text)


def table(name: str) -> TableQuery:
    return default_context().table(name)


def explain(text: str) -> str:
    return default_context().explain(text)
