"""Session flags (the SQLConf analog).

Only the flags this package reads, with the JAX package's defaults.  A flag
of a tier the port does not have yet (cost model, host fallback, serving,
ingest, storage, cluster, tracing) is absent, so `SET` on it raises
KeyError instead of reporting a change that nothing reads; each comes back
with the slice that reads it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SessionConfig:
    """Session-wide planner flags."""

    # rewrite enables (reference: per-transform enable flags)
    enable_rewrites: bool = True
    enable_topn_rewrite: bool = True  # Sort+Limit -> TopN
    enable_join_collapse: bool = True  # star-schema join elimination

    # COUNT(DISTINCT x) handling: "approx" rewrites to a sketch (Druid
    # default); "exact" uses the exact distinct path; "error" rejects.
    # Neither sketches nor the exact path are ported: both raise
    # NotImplementedError (ROADMAP queue A item 4).
    count_distinct_mode: str = "approx"

    # result guard (reference: maxCardinality / maxResultCardinality)
    max_result_cardinality: int = 1 << 22
    # non-aggregate queries (reference: nonAggregateQueryHandling = push/scan)
    non_aggregate_query_handling: str = "scan"  # "scan" | "error"
