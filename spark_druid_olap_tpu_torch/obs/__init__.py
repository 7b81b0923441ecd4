"""Observability: per-query span traces, process metrics, cost receipts.

  * `obs.trace`: an injectable-clock span tracer producing a per-query span
    tree under a Druid `query_id`, a bounded trace ring served over HTTP,
    and the slow-query log;
  * `obs.registry`: the process-wide Prometheus metrics registry
    (counters, gauges, histograms) the engine, the resilience layer, the
    serving core and the HTTP server publish into, rendered at
    `GET /status/metrics`;
  * `obs.prof`: sampled device timing with CUDA events, per-query cost
    receipts and the workload profiler behind `GET /status/profile`;
  * `obs.otlp`: the emit-only OTLP/JSON export of finished traces;
  * `obs.telemetry`: the `__sys` sampler, which appends the registry's
    readings to a datasource through the ingest and WAL tier, so the
    process's own history is one SQL query away.

Instrumented code imports from here (`from ..obs import span, SPAN_...`).
"""

from .registry import (  # noqa: F401
    MetricsRegistry,
    bounded_label,
    get_registry,
    record_cluster_health,
    record_cluster_rpc,
    record_compaction,
    record_ingest,
    record_partial,
    record_query_metrics,
    record_rollup,
    record_snapshot_flush,
    record_snapshot_sweep,
    record_storage_load,
    record_wal_append,
    record_wal_replay,
)
from . import prof  # noqa: F401
from .trace import (  # noqa: F401
    SPAN_ADAPTIVE_PROBE,
    SPAN_ADMISSION,
    SPAN_ARENA_BUILD,
    SPAN_CLUSTER_MERGE,
    SPAN_CLUSTER_RPC,
    SPAN_COLLECTIVE_MERGE,
    SPAN_COMPACT,
    SPAN_DEGRADED,
    SPAN_DEVICE_FETCH,
    SPAN_EXECUTE,
    SPAN_FALLBACK,
    SPAN_FALLBACK_DECODE,
    SPAN_FINALIZE,
    SPAN_FUSED_BATCH,
    SPAN_GATHER,
    SPAN_H2D,
    SPAN_INGEST,
    SPAN_INGEST_ENCODE,
    SPAN_LANE,
    SPAN_LOWER,
    SPAN_NAMES,
    SPAN_PARTIAL,
    SPAN_PLAN,
    SPAN_QUERY,
    SPAN_RETRY,
    SPAN_ROLLUP,
    SPAN_SCATTER,
    SPAN_SEGMENT_DISPATCH,
    SPAN_SNAPSHOT_FLUSH,
    SPAN_SPARSE_DISPATCH,
    SPAN_STREAM_CHUNK,
    SPAN_STREAM_FLUSH,
    SPAN_WAL_APPEND,
    SPAN_WAL_REPLAY,
    QueryTrace,
    Span,
    TraceRing,
    Tracer,
    current_query_id,
    current_span,
    current_trace,
    default_tracer,
    new_query_id,
    span,
    span_event,
    span_in,
)
