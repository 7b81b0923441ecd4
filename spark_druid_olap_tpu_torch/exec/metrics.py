"""Per-query execution metrics, filled by `exec/engine.py` on every execution
and kept on `Engine.last_metrics`.

Phase semantics (wall clock, single process):
  * `h2d_ms` / `h2d_bytes` — host->device column transfers this query caused
    (zero on residency-cache hits).
  * `device_ms` — the segment loop up to the synchronising fetch of the
    merged [G, M] state.
  * `finalize_ms` — host-side result materialization.
  * `total_ms` — the whole execution.

Tier fields (`exec/adaptive_exec.py`, `exec/sparse_exec.py`): `strategy`
names the path that answered ("adaptive", "sparse", or the kernel strategy
"cuda", "dense", "segment"); `declines` holds the reason of every tier that
declined the query on the way there.  Adaptive: `compact_groups` (G'),
`kept_source` ("measured" by a presence pass, "derived" from the filter,
or "memo") and `inner_strategy` (the compacted pass's kernel strategy).
Sparse: `sparse_slots` and `sparse_row_capacity` (the rungs that answered;
0 = a full-segment sort), `sparse_passes` (passes over the segments, one
more for every rung climbed) and `inner_strategy`.

Dispatch (`exec/arena.py`): `dispatch_count` counts the host calls that
ran the query's segment work: one per arena program run (a CUDA graph
replay on a card, the body called eagerly on the CPU) plus one per segment
the eager loop ran.  `arena_segments` are the segments an arena program
covered, `graph_captures` / `graph_replays` the graphs captured and
replayed, `capture_ms` the capture's host time.  Every reason the arena
declined a scope goes to `declines` with the prefix "arena:"
(`tier_declines` leaves those out).

Scan and Search (`Engine._execute_scan`, `_execute_search`): `segments`
and `rows_scanned` count the segments the loop visited (an unordered LIMIT
stops early), `d2h_bytes` the scan's rows copied back to the host.

Host fallback (`api._run_fallback`): `executor` says which executor
answered: "device" (the engine), "fallback" (the host interpreter of
`exec/fallback.py`) or "device+fallback" (the interpreter, with
`assist_subplans` Aggregate subtrees run on the engine); `declines` then
holds one reason for every subtree the assist did not run.

Resilience (`resilience.py`): `retries` counts the transient-failure
re-dispatches the query paid; `degraded` says it was answered on the host
fallback (the device failed after its retries, or its breaker was open);
`deadline_exceeded` that it died on its deadline; `circuit_state` is the
device breaker's state when the query was routed and `error_class` the
class of the exception it failed on.  `partial` marks a deadline-bounded
best-effort answer, `coverage` the share of in-scope rows it saw (None when
the denominator is unknown, as for a stream) and `rows_seen` their count,
`delta_rows_seen` the share of them from delta segments (streamed appends;
on a delta-aware result-cache refresh, the delta rows it scanned).

Serving and observability (`serve/`, `obs/`): `query_id` is the id of the
query's trace (Druid's `context.queryId` on the server, generated
otherwise); `receipt` the query's cost receipt (`obs/prof.build_receipt`:
device, host and transfer ms from its span tree, the cache outcomes, and
whether its device time came from CUDA events on a sampled query);
`fused_batch` the size of the fused micro-batch it rode (0: none); `lane`
the admission lane the server routed it through; `result_cache` "hit" when
the result cache answered it with no device work, "delta" when it merged
a cached partial state with the partials of the segments appended since
(the strategy is then "result-cache-delta"), "miss" when the cache was
asked and missed, "" when it was not asked.

Multi-device (`parallel/distributed.py`): `distributed` marks an execution
of the mesh engine, `mesh_shape` its mesh's axis sizes ((data, groups), or
(slice, data) on a slice mesh); `device` is then the first shard's device
and `shard_device_ms` each row shard's device time on a sampled query (CUDA
events around the shard's work; empty otherwise).  `est_collective_ms` is
the cost model's price of the merge, `merge_tree` the tree that ran.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class QueryMetrics:
    query_type: str = ""
    strategy: str = ""
    executor: str = "device"
    datasource: str = ""
    device: str = ""
    rows_scanned: int = 0
    # bytes of segment data the query reads (needed columns x rows, incl.
    # validity): the numerator of a scan-bandwidth roofline
    bytes_scanned: int = 0
    segments: int = 0
    num_groups: int = 0
    h2d_bytes: int = 0
    h2d_ms: float = 0.0
    # device->host bytes of a Scan's rows (one copy per segment)
    d2h_bytes: int = 0
    device_ms: float = 0.0
    finalize_ms: float = 0.0
    total_ms: float = 0.0
    bytes_resident: int = 0
    declines: List[str] = dataclasses.field(default_factory=list)
    inner_strategy: str = ""
    compact_groups: Optional[int] = None
    kept_source: str = ""
    sparse_slots: Optional[int] = None
    sparse_row_capacity: Optional[int] = None
    sparse_passes: int = 0
    assist_subplans: int = 0
    dispatch_count: int = 0
    arena_segments: int = 0
    graph_captures: int = 0
    graph_replays: int = 0
    capture_ms: float = 0.0
    retries: int = 0
    degraded: bool = False
    deadline_exceeded: bool = False
    circuit_state: str = ""
    error_class: Optional[str] = None
    partial: bool = False
    coverage: Optional[float] = None
    rows_seen: int = 0
    delta_rows_seen: int = 0
    query_id: str = ""
    receipt: Optional[dict] = None
    fused_batch: int = 0
    lane: str = ""
    result_cache: str = ""
    distributed: bool = False
    mesh_shape: Optional[tuple] = None
    merge_tree: str = ""
    est_collective_ms: float = 0.0
    shard_device_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def tier_declines(self) -> List[str]:
        """The declines of the tiers, without the arena's and the result
        cache's."""
        return [d for d in self.declines if not d.startswith(("arena:", "result-cache:"))]

    @property
    def rows_per_sec(self) -> float:
        if self.total_ms <= 0:
            return 0.0
        return self.rows_scanned / (self.total_ms / 1e3)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rows_per_sec"] = self.rows_per_sec
        return d

    def describe(self) -> str:
        return (
            f"QueryMetrics[{self.query_type} strategy={self.strategy} "
            f"executor={self.executor} assists={self.assist_subplans} "
            f"device={self.device} rows={self.rows_scanned} "
            f"segments={self.segments} groups={self.num_groups} "
            f"compact_groups={self.compact_groups} slots={self.sparse_slots} "
            f"row_capacity={self.sparse_row_capacity} declines={self.declines} "
            f"dispatches={self.dispatch_count} arena_segments={self.arena_segments} "
            f"captures={self.graph_captures} replays={self.graph_replays} "
            f"total={self.total_ms:.2f}ms (h2d={self.h2d_ms:.2f}ms/"
            f"{self.h2d_bytes}B device={self.device_ms:.2f}ms "
            f"finalize={self.finalize_ms:.2f}ms) "
            f"rows/s={self.rows_per_sec:,.0f} resident={self.bytes_resident}B"
            + (f" retries={self.retries}" if self.retries else "")
            + (f" fused_batch={self.fused_batch}" if self.fused_batch else "")
            + (f" result_cache={self.result_cache}" if self.result_cache else "")
            + (" DEGRADED" if self.degraded else "")
            + (" DEADLINE-EXCEEDED" if self.deadline_exceeded else "")
            + (
                f" PARTIAL(coverage="
                f"{'?' if self.coverage is None else round(self.coverage, 4)})"
                if self.partial
                else ""
            )
            + (
                f" circuit={self.circuit_state}"
                if self.circuit_state and self.circuit_state != "closed"
                else ""
            )
            + "]"
        )
