"""Session flags (the SQLConf analog).

Only the flags this package reads, with the JAX package's defaults.  A flag
of a tier the port does not have yet (the cost model, multi-device, the
cluster) is absent, so `SET` on it raises KeyError instead of
reporting a change that nothing reads; each comes back with the slice that
reads it.  `SET` applies a flag at once (`TPUOlapContext.apply_config`):
the serving and tracing flags reach the result cache, the fusion
scheduler, the admission and lane pools and the tracer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SessionConfig:
    """Session-wide planner flags."""

    # rewrite enables (reference: per-transform enable flags)
    enable_rewrites: bool = True
    enable_topn_rewrite: bool = True  # Sort+Limit -> TopN
    enable_join_collapse: bool = True  # star-schema join elimination

    # approx-distinct mapping (reference: pushHLLTODruid / useApproxCountDistinct)
    approx_count_distinct_sketch: str = "hll"  # "hll" | "theta"
    hll_precision: int = 11
    theta_size: int = 4096
    # COUNT(DISTINCT x) handling: "approx" rewrites to a sketch (Druid
    # default); "exact" groups by x on the device and counts on the host
    # (plan/planner._plan_exact_distinct); "error" rejects.
    count_distinct_mode: str = "approx"
    # APPROX_QUANTILE sample size K (quantilesDoublesSketch k analog):
    # rank error ~ O(sqrt(p(1-p)/K)), ~±1.5% at the median for 1024
    quantiles_k: int = 1024

    # result guard (reference: maxCardinality / maxResultCardinality)
    max_result_cardinality: int = 1 << 22
    # non-aggregate queries (reference: nonAggregateQueryHandling = push/scan)
    non_aggregate_query_handling: str = "scan"  # "scan" | "error"

    # host fallback (exec/fallback.py): a plan the planner cannot rewrite is
    # interpreted over decoded host frames instead of raising RewriteError;
    # False surfaces the RewriteError
    fallback_execution: bool = True
    # ceiling on the summed base-table rows one fallback query may decode
    # (single-threaded pandas); 0 disables the guard
    fallback_max_rows: int = 50_000_000
    # device assist: an Aggregate subtree of a fallback plan over at least
    # this many input rows is offered to the planner and, when it rewrites,
    # runs on the engine; below it the host answers in float64
    device_assist_min_rows: int = 1 << 18
    # assist a subtree even where the rules would decline it (a Timeseries,
    # TopN or exact-distinct rewrite under 2^23 rows); the row floor stays
    device_assist_force: bool = False

    # transfer pipeline (exec/pipeline.py): a cold segment column is
    # copied from a pinned host copy kept per column, a DMA the host does
    # not wait for; the first copy of a column pins it.  False: copies
    # from the segments' pageable arrays.  The same bits either way
    transfer_pipeline: bool = True
    # one dispatch per query scope (exec/arena.py): a scope's segment loop
    # is captured as a CUDA graph on its second execution and replayed
    # after; the same bits as the loop.  False keeps every scope on the loop
    arena_execution: bool = True

    # query-lifecycle resilience (resilience.py).  A wall-clock budget per
    # query in ms (0: none), checked between segments, chunks and
    # interpreter stages; under a budget an arena scope replays in chunks
    query_timeout_ms: int = 0
    # a deadline that expires mid-scan answers with the partials merged so
    # far, stamped partial=True with a coverage fraction; False raises
    # DeadlineExceeded instead
    partial_results: bool = True
    # attempts of one group-by execution after a transient failure (in all,
    # so 2 = one retry) and the backoff before the first retry (doubling)
    retry_max_attempts: int = 2
    retry_backoff_ms: float = 25.0
    # consecutive transient failures that open a backend's breaker, and the
    # cooldown before a half-open probe
    breaker_failure_threshold: int = 3
    breaker_cooldown_ms: int = 2000

    # -- serving (serve/, server.py) -----------------------------------------
    # result cache (the Druid broker's result cache): a repeated query over
    # the same datasource version answers with no device work.  Entries key
    # on the query's JSON, the dictionary signature and the session flags,
    # and carry the datasource version they were computed at.  0 disables
    result_cache_entries: int = 64
    # delta-aware reuse: after an append publishes new segments (and retires
    # none), a cached entry's partial state is merged with the partials of
    # the appended segments alone, instead of running the query in full.  A
    # dictionary extension changes the key (a full miss).  False keeps
    # version-exact hits only
    result_cache_delta_reuse: bool = True
    # micro-batch fusion: compatible concurrent GroupBy-family queries over
    # one datasource wait this many ms for each other and run as one fused
    # execution (one captured CUDA graph over resident segments).  0
    # disables: every query runs alone
    fusion_window_ms: float = 0.0
    # the most queries fused into one execution
    fusion_max_batch: int = 16
    # arm the window from the observed arrival rate: no wait on an idle
    # queue, up to fusion_window_max_ms under a burst
    fusion_adaptive_window: bool = False
    # burst ceiling of the adaptive window; 0 = 4x fusion_window_ms
    fusion_window_max_ms: float = 0.0
    # priority lanes (serve/lanes.py): separate admission slot pools, so
    # cheap dashboard queries never queue behind large scans.  A Scan,
    # Search or GroupBy goes heavy above lane_heavy_rows in-scope rows;
    # TopN, Timeseries and metadata queries stay interactive
    lane_interactive_slots: int = 6
    lane_heavy_slots: int = 2
    lane_heavy_rows: int = 4 << 20
    # admission control: a bounded slot pool with a queue-wait timeout; a
    # full pool answers 503 with Retry-After
    max_concurrent_queries: int = 8
    admission_queue_timeout_ms: int = 2000

    # -- streamed ingest (ingest/) ----------------------------------------------
    # rows per published delta segment before an append batch splits (the
    # floor is catalog.segment.ROW_PAD, the padding granularity)
    delta_seal_rows: int = 1 << 16
    # background compaction: the sweep period, and the delta-row backlog
    # below which a datasource is left alone (a sweep also compacts once 64
    # delta segments accrue, whatever their rows)
    compaction_interval_s: float = 5.0
    compaction_min_delta_rows: int = 1 << 15
    # rows per historical segment compaction emits
    compaction_rows_per_segment: int = 1 << 19
    # ingest admission: a slot pool of its own, so appends (encode, and a
    # dictionary extension's remap) and queries cannot starve each other
    max_concurrent_ingests: int = 2
    ingest_queue_timeout_ms: int = 2000

    # -- durable storage (storage.py, ingest/wal.py, catalog/persist.py) --------
    # root of the durable tier: per-datasource append WALs and versioned
    # columnar snapshots.  None keeps the catalog in the process (nothing
    # survives a restart).  When set, a context recovers at construction:
    # the snapshots load memory-mapped and the WALs replay past them
    storage_dir: Optional[str] = None
    # fsync each WAL record before the publish and the acknowledgement (the
    # durability guarantee); False gives it up for append latency
    storage_fsync: bool = True
    # every this many seconds a thread flushes each datasource whose
    # published version moved past its snapshot, so a restart maps instead
    # of replaying; 0 starts no thread (appends stay durable through the WAL)
    snapshot_flush_s: float = 0.0

    # -- observability (obs/) --------------------------------------------------
    # slow-query log: a finished query whose span-tree total reaches this
    # logs its rendered tree at WARNING; 0 disables
    slow_query_ms: float = 0.0
    # finished span trees kept for GET /druid/v2/trace/{query_id}
    trace_ring_capacity: int = 64
    # emit-only OTLP export: every finished trace appends one OTLP/JSON
    # line to this file; None disables
    otlp_export_path: Optional[str] = None
    # share of queries sampled for device timing: a sampled query records
    # CUDA events around its dispatches and waits on them (one sync each);
    # 0 adds no sync
    prof_sample_rate: float = 0.0
    # GET /status/profile's rolling window and top-K
    profile_window_s: float = 300.0
    profile_top_k: int = 10
    # per-lane latency targets the profiler burns its SLO against; 0
    # disables a lane's burn rate
    lane_interactive_slo_ms: float = 250.0
    lane_heavy_slo_ms: float = 30_000.0
    # the `__sys` telemetry sampler (obs/telemetry.py): above 0, a thread
    # appends the metrics registry's readings to the `__sys` datasource every
    # this many seconds (through the ingest and WAL tier, rolled up at
    # `second` granularity); 0 registers nothing and starts no thread
    sys_sampler_s: float = 0.0
    # series one sampler tick appends at most (the cardinality guard)
    sys_sampler_max_series: int = 512
    # the compaction sweep drops each historical `__sys` segment whose newest
    # row is older than this many seconds (whole segments); 0 keeps all
    sys_retention_s: float = 0.0
