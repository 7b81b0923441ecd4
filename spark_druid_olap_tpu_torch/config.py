"""Session flags (the SQLConf analog).

Only the flags this package reads, with the JAX package's defaults, except
the cost model's constants: those are the port's own, measured on its card
(`plan/calibrate.py`), and the merge's rates, which are the H100's data
sheet's and an assumption about the host link.  A flag that nothing in the
port reads is absent, so `SET` on it raises KeyError instead of reporting a
change that nothing reads.  `SET` applies a flag at once
(`TPUOlapContext.apply_config`): the serving and tracing flags reach the
result cache, the fusion scheduler, the admission and lane pools and the
tracer, and the seven `cluster_*` flags the broker's `ClusterClient`
(`cluster/broker.py`) when one is attached.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from .utils.log import get_logger

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's calibration of its card, written by `python -m
# spark_druid_olap_tpu_torch.plan.calibrate` on the card and committed; the
# CPU has a built-in profile and no file
CUDA_CALIBRATION = os.path.join(_REPO_ROOT, "calibration.torch_cuda.json")

# the constants a calibration file sets (plan/calibrate.py writes them)
CALIBRATED_FLOATS = (
    "cost_per_row_dense",
    "cost_per_row_scatter",
    "cost_per_row_scatter_hi",
    "cost_per_row_sparse",
    "cost_per_row_compact",
    "cost_per_group_state",
    "cost_dispatch_us",
    "h2d_bytes_per_s",
    "cost_per_row_interp",
    "cost_per_group_decode",
)
CALIBRATED_INTS = ("dense_tile_groups", "scatter_lo_groups", "scatter_hi_groups")
# measured only on a host with two or more cards (None in a file of one):
# applied where the file has it
MULTI_CARD_FLOATS = ("collective_bytes_per_us",)


log = get_logger("config")


def calibration_device(device=None) -> torch.device:
    """The device a calibration is of: `device`, else the card when there
    is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def device_name(device=None) -> str:
    """The name a calibration file records for `device`: the card's
    (`torch.cuda.get_device_name`), or "cpu"."""
    device = calibration_device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


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
    # the assist's cost decision (api._run_fallback): a subtree is assisted
    # when its modelled engine time, at least 3x over, beats rows x
    # cost_per_row_interp, the host fallback interpreting an Aggregate
    # subtree (us per input row); the engine side re-pays
    # cost_per_group_decode (us) per result group on the host (the fetch,
    # the decode, the frame).  Both are host constants, measured by
    # plan/calibrate.py on the host of the card below, and apply on every
    # device
    cost_per_row_interp: float = 0.7041531702677367
    cost_per_group_decode: float = 0.09857616424560679
    # assist a subtree even where the rules or the cost decision would
    # decline it; the row floor stays
    device_assist_force: bool = False

    # -- the cost model (plan/cost.py) -------------------------------------------
    # Each query's kernel class (dense, segment, sparse, adaptive) is the
    # cheapest by these constants, in microseconds (bytes/s for the link).
    # The defaults are the port's calibration of one NVIDIA H100 80GB HBM3 at
    # 700.00 W (calibration.torch_cuda.json, written by `python -m
    # spark_druid_olap_tpu_torch.plan.calibrate` on the card);
    # `load_calibrated()` reads that file on a card and applies the built-in
    # CPU profile on the CPU.  False: dense up to dense_max_groups, else
    # sparse where it applies, else segment
    cost_model_enabled: bool = True
    # the dense class's widest domain; on a card the kernel takes at most
    # SCATTER_CUTOVER (4096) groups, whatever this says
    dense_max_groups: int = 4096
    # the dense class: us per row per tile of dense_tile_groups groups.  The
    # kernel reads its rows once whatever G is; its time grows with G by the
    # measured tile width (the plain version on the CPU: its one-hot product)
    cost_per_row_dense: float = 5.786259968976858e-06
    dense_tile_groups: int = 2348
    # the scatter (index_add_): us per row at scatter_lo_groups and at
    # scatter_hi_groups, interpolated in log G between them, plus us per
    # group of state per segment
    cost_per_row_scatter: float = 0.0005513193209965728
    cost_per_row_scatter_hi: float = 0.0005513193209965728
    scatter_lo_groups: int = 1024
    scatter_hi_groups: int = 1048576
    cost_per_group_state: float = 8.651479830880916e-06
    # the sparse tier: us per sorted row (the sort-reduce pass over 4096
    # slots) and per row of the compaction pass ahead of it
    cost_per_row_sparse: float = 0.00015026664733881222
    cost_per_row_compact: float = 0.0005513193209965728
    # one launch and its sync (us); the host-to-card link from pinned memory
    cost_dispatch_us: float = 65.12599999908275
    h2d_bytes_per_s: float = 45286504919.31948
    # the mesh's merge (`parallel/mesh.py`), bytes per us: NVLink's rate
    # between two H100 cards, 450 GB/s each way, from NVIDIA's data sheet
    # (measured into the calibration only on a host with several cards)
    collective_bytes_per_us: float = 450_000.0
    # the slice hop of a slice mesh (`plan/cost.choose_merge_tree`): an
    # assumed host-to-host link of 50 GB/s (a 400 Gb/s NIC), unmeasured
    dcn_bytes_per_us: float = 50_000.0
    # multi-device execution (`parallel/distributed.py`): with more than one
    # device in the context's list, plan the mesh when it is modelled
    # cheaper; the data axis (None: the devices left by the groups axis)
    # and the groups axis that shards the group domain
    prefer_distributed: bool = True
    mesh_data_axis: Optional[int] = None
    mesh_groups_axis: int = 1
    # where the cost constants came from (`load_calibrated`): {"path",
    # "device", "power_limit", "partial", "applied", "source"}, and
    # "mismatch" when a file of another device was ignored; None when the
    # config was built directly (the class defaults)
    calibration_meta: Optional[dict] = None

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

    # -- the cluster tier (cluster/) --------------------------------------------
    # replicas per segment in the broker's assignment (rendezvous hashing over
    # the historicals' node ids), clamped to the membership
    cluster_replication: int = 2
    # one scatter attempt's budget: past it the broker fails over to the next
    # replica of the chain
    cluster_rpc_timeout_ms: float = 5000.0
    # re-walks of the replica chain after every replica failed once
    cluster_rpc_retries: int = 1
    # hedging: when the primary has not answered within this, the same fetch
    # goes to the next replica and the first answer wins; 0 disables it
    cluster_hedge_ms: float = 0.0
    # the per-historical breaker: consecutive failed attempts before it opens,
    # and its cooldown before a probe
    cluster_breaker_failures: int = 3
    cluster_breaker_cooldown_ms: float = 2000.0
    # per-node budget of the broker's federated scrape (/status/metrics?cluster=1
    # and /status/profile?cluster=1); a slower node is stamped stale
    cluster_scrape_timeout_ms: float = 2000.0

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

    @classmethod
    def load_calibrated(cls, path: Optional[str] = None, device=None) -> "SessionConfig":
        """A config with the cost constants measured on `device` (default:
        the card when there is one, else the CPU).  On a card: the committed
        `calibration.torch_cuda.json` (or `path`) when it was measured on a
        card of the same name, else the class defaults.  On the CPU: the
        built-in CPU profile (`apply_platform_profile`), and a file only
        when `path` names one.  A file of another device is ignored with a
        warning: constants of one device route another's queries badly.
        `calibration_meta` records what was applied."""
        cfg = cls().apply_platform_profile(device)
        cur = device_name(device)
        source = "cpu profile" if cur == "cpu" else "defaults"
        if path is None and cur != "cpu":
            path = CUDA_CALIBRATION
        meta = {"path": None, "device": cur, "power_limit": None, "partial": None,
                "applied": False, "source": source}
        data = None
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = None
            if not isinstance(data, dict):
                log.warning("ignoring unreadable calibration file %s; using the %s", path, source)
                data = None
        if data is not None and data.get("device") != cur:
            log.warning(
                "ignoring calibration file %s measured on %s (the device is %s); using "
                "the %s: run `python -m spark_druid_olap_tpu_torch.plan.calibrate` here",
                path, data.get("device"), cur, source)
            meta.update(path=path, device=data.get("device"), partial=data.get("partial"),
                        power_limit=data.get("power_limit"), mismatch=True)
            data = None
        if data is not None:
            for k in CALIBRATED_FLOATS:
                if data.get(k) is not None and data[k] > 0:
                    setattr(cfg, k, float(data[k]))
            for k in CALIBRATED_INTS:
                if data.get(k) is not None and data[k] > 0:
                    setattr(cfg, k, int(data[k]))
            for k in MULTI_CARD_FLOATS:
                if data.get(k) is not None and data[k] > 0:
                    setattr(cfg, k, float(data[k]))
            meta.update(path=path, power_limit=data.get("power_limit"),
                        partial=data.get("partial"), applied=True, source="file")
        cfg.calibration_meta = meta
        return cfg

    def apply_platform_profile(self, device=None) -> "SessionConfig":
        """Overwrite (in place) the cost constants with the CPU profile when
        `device` is the CPU; on a card the class defaults, the H100's, stay.
        The profile is `python -m spark_druid_olap_tpu_torch.plan.calibrate
        --device cpu --rows 131072 --launches 2` run over the port's plain
        versions on 8 cores of an Intel Xeon (the dense class is the one-hot
        product there, not the kernel); it routes the CPU's queries and
        tests and is no speed result."""
        if calibration_device(device).type != "cpu":
            return self
        self.cost_per_row_dense = 0.14642043304202712
        self.dense_tile_groups = 186
        self.cost_per_row_scatter = 0.033783467615992414
        self.cost_per_row_scatter_hi = 0.03499985250695244
        self.scatter_lo_groups = 1024
        self.scatter_hi_groups = 1048576
        self.cost_per_group_state = 6.469034409920919e-05
        self.cost_per_row_sparse = 7.579217508953591
        self.cost_per_row_compact = 0.033783467615992414
        self.cost_dispatch_us = 11.244001143495552
        self.h2d_bytes_per_s = 5059719217.713223
        return self
