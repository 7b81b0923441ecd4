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

    # approx-distinct mapping (reference: pushHLLTODruid / useApproxCountDistinct)
    approx_count_distinct_sketch: str = "hll"  # "hll" | "theta"
    hll_precision: int = 11
    theta_size: int = 4096
    # COUNT(DISTINCT x) handling: "approx" rewrites to a sketch (Druid
    # default); "exact" uses the exact distinct path, which is not ported
    # and raises NotImplementedError (ROADMAP queue A item 4); "error"
    # rejects.
    count_distinct_mode: str = "approx"
    # APPROX_QUANTILE sample size K (quantilesDoublesSketch k analog):
    # rank error ~ O(sqrt(p(1-p)/K)), ~±1.5% at the median for 1024
    quantiles_k: int = 1024

    # result guard (reference: maxCardinality / maxResultCardinality)
    max_result_cardinality: int = 1 << 22
    # non-aggregate queries (reference: nonAggregateQueryHandling = push/scan)
    non_aggregate_query_handling: str = "scan"  # "scan" | "error"
