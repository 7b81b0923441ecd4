"""Session flags (the SQLConf analog).

Only the flags this package reads, with the JAX package's defaults.  A flag
of a tier the port does not have yet (the cost model, ingest and storage,
multi-device, the cluster, the result cache's delta reuse, the `__sys`
telemetry sampler) is absent, so `SET` on it raises KeyError instead of
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
