"""Performance attribution: sampled device timing and per-query receipts.

The span tree (obs/trace.py) records when phases ran; this module makes the
device numbers honest and folds them into per-query cost receipts:

  * **Sampled device timing.**  CUDA work is asynchronous, so a span around
    a graph replay or a segment loop measures the host's enqueue time, not
    the card's.  `device_timer` records CUDA events on the compute stream
    around a dispatch and, on a query sampled by
    `SessionConfig.prof_sample_rate`, waits on the closing event and writes
    the events' elapsed time into the span (`device_ms`, beside the host's
    `enqueue_ms`).  On an unsampled query it is one contextvar read: no
    event, no sync, and the card runs ahead of the host as before.
    `transfer_sync` and `fetch_sync` do the same for an h2d copy and the
    wait before a fetch, and `dispatch_sync` for a dispatch timed by a
    device-wide sync.  Every sync they add is counted (`ProfScope.syncs`
    and the process-wide `SYNCS`), so a run can show the default rate adds
    none.  Events inside a replayed graph cannot be split per segment: a
    replay is timed whole.
  * **Transfer and residency accounting.**  Every h2d copy records bytes
    and effective MB/s into `sdol_h2d_link_mbps`; residency gauges and
    eviction counters per datasource.
  * **Program-cache families.**  Hit/miss counters and capture time per
    program family: a CUDA graph capture is the port's compile, under the
    families `arena` (a scope's graph), `arena-fused` (a fused micro-batch's
    graph) and `fused-batch` (the fused eager loop, which captures
    nothing).
  * **Per-query cost receipts.**  `build_receipt` folds a finished span
    tree into {device_ms, host_ms, transfer_ms, unattributed_ms, ...} by
    summing each span's exclusive time (duration minus children) into a
    bucket by span name.  Only the root span's exclusive time is
    unattributed.  On a sampled query on a card, `device_ms` is the sum of
    the CUDA-event times instead, and `device_timing` says which the
    receipt holds ("cuda_events" or "span").  Receipts are stamped into the
    trace document, `QueryMetrics.receipt`, `df.attrs["receipt"]` and, on
    sampled queries, the `X-Druid-Response-Context` header.
  * **The workload profiler.**  A process-wide rolling window of finished
    queries behind `GET /status/profile`: top-K by device time, capture
    totals per family, per-lane SLO burn rate against the `lane_*_slo_ms`
    targets.

Capture time happens inside the first replay's dispatch span, so a
receipt's `device_ms` includes it; `compile_ms` reports it apart, as
detail, never as an additive term.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils.log import get_logger
from .registry import bounded_label, get_registry
from .trace import current_query_id, current_span, current_trace

log = get_logger("obs.prof")

# effective host->device MB/s per transfer
LINK_MBPS_BUCKETS = (
    1.0, 5.0, 10.0, 25.0, 45.0, 75.0, 150.0, 500.0,
    1000.0, 5000.0, 20000.0,
)

# span name -> receipt bucket.  Device spans enqueue device work or block
# on it; h2d is the transfer bucket; arena_build (a graph capture) has its
# own; every other span's exclusive time is host work.  The root span's
# exclusive time stays unattributed.
DEVICE_SPANS = frozenset(
    {
        "segment_dispatch",
        "collective_merge",
        "device_fetch",
        "sparse_dispatch",
        "adaptive_probe",
        "stream_chunk",
    }
)
TRANSFER_SPANS = frozenset({"h2d"})
ARENA_SPANS = frozenset({"arena_build"})
# the cluster's broker (cluster/): the scatter span is the replica fetches in
# flight, gather the merge of what came back, cluster_merge one state's
# fold; each its own bucket, so a slow cluster query attributes to the
# wire, the gather or the merge and not to host time
SCATTER_SPANS = frozenset({"scatter"})
GATHER_SPANS = frozenset({"gather"})
CLUSTER_MERGE_SPANS = frozenset({"cluster_merge"})
# one replica attempt: these run concurrently on pool threads under the one
# scatter span, so they overlay its wall instead of partitioning it; their
# time, and the remote subtrees grafted under them (on the remote clock),
# fold into the receipt's per-historical `cluster.nodes` section and never
# into the additive buckets
CLUSTER_RPC_SPANS = frozenset({"cluster_rpc"})
ROOT_SPAN = "query"

# device launch spans: the receipt's `dispatch_count`, the host calls that
# ran a query's device work (a graph replay is one); device_fetch is a
# read-back, not a launch
DISPATCH_SPANS = frozenset(
    {
        "segment_dispatch",
        "collective_merge",
        "sparse_dispatch",
        "adaptive_probe",
        "stream_chunk",
    }
)

# every sync the sampled timing added in this process: the default rate
# (0) must leave it unmoved
SYNCS = 0
_syncs_lock = threading.Lock()


class ProfScope:
    """Per-query attribution accumulators, armed by the tracer for the
    lifetime of one query trace.  `sampled` gates the sampled device
    timing; the cheap counters (cache outcomes, transfer bytes) collect on
    every traced query.  Contextvar-confined like the trace itself (new
    threads see no scope)."""

    __slots__ = (
        "sampled",
        "lane",
        "syncs",
        "transfer_ms",
        "transfer_bytes",
        "compiles",
        "compile_ms",
        "residency_hits",
        "residency_misses",
        "program_cache",
        "result_cache",
        "fused_batch",
        "pending_family",
    )

    def __init__(self, sampled: bool = False):
        self.sampled = bool(sampled)
        self.lane = ""
        self.syncs = 0
        self.transfer_ms = 0.0
        self.transfer_bytes = 0
        self.compiles = 0
        self.compile_ms = 0.0
        self.residency_hits = 0
        self.residency_misses = 0
        # family -> [hits, misses]
        self.program_cache: Dict[str, List[int]] = {}
        self.result_cache: Optional[str] = None  # "hit" when served
        self.fused_batch = 0
        self.pending_family: Optional[str] = None


_active: contextvars.ContextVar[Optional[ProfScope]] = contextvars.ContextVar(
    "sdol_torch_active_prof", default=None
)


def current_scope() -> Optional[ProfScope]:
    return _active.get()


def activate(scope: ProfScope):
    """Internal (tracer lifecycle): arm `scope` for this context."""
    return _active.set(scope)


def deactivate(token) -> None:
    _active.reset(token)


def profiled() -> bool:
    """Is the current query sampled for device timing?"""
    ps = _active.get()
    return ps is not None and ps.sampled


class RateSampler:
    """Deterministic rate sampler: an accumulator advances by `rate` per
    query and fires on integer crossings; rate 1.0 samples every query,
    0.25 every fourth, 0 never.  No clock or RNG, so tests and runs know
    exactly which queries paid a sync."""

    def __init__(self, rate: float = 0.0):
        self.rate = float(rate)
        self._acc = 0.0
        self._force = False
        self._lock = threading.Lock()

    def force_next(self) -> None:
        with self._lock:
            self._force = True

    def take(self) -> bool:
        with self._lock:
            if self._force:
                self._force = False
                return True
            r = self.rate
            if r <= 0:
                return False
            if r >= 1.0:
                return True
            self._acc += r
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
            return False


# ---------------------------------------------------------------------------
# Sampled device timing
# ---------------------------------------------------------------------------


def _note_sync(ps: ProfScope) -> None:
    global SYNCS
    ps.syncs += 1
    with _syncs_lock:
        SYNCS += 1


def _on_card(device) -> bool:
    return device is not None and getattr(device, "type", str(device)) == "cuda"


@contextlib.contextmanager
def device_timer(device):
    """Around one dispatch (a graph replay, a segment loop, a chunk).  On a
    sampled query on a card: CUDA events recorded on the compute stream
    before and after the block, a wait on the closing one, and the
    enclosing span's attrs `enqueue_ms` (host time of the block),
    `device_ms` (the events' elapsed time) and `timing` = "cuda_events".
    On a sampled query on the CPU the block is synchronous: its host time
    is the device time (`timing` = "host").  Unsampled: nothing."""
    ps = _active.get()
    if ps is None or not ps.sampled:
        yield
        return
    s = current_span()
    if not _on_card(device):
        t0 = time.perf_counter()
        yield
        if s is not None:
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            s.attrs.update(enqueue_ms=ms, device_ms=ms, timing="host")
        return
    import torch

    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    t0 = time.perf_counter()
    yield
    t1 = time.perf_counter()
    end.record(stream)
    end.synchronize()
    _note_sync(ps)
    if s is not None:
        s.attrs["enqueue_ms"] = round((t1 - t0) * 1e3, 3)
        s.attrs["device_ms"] = round(start.elapsed_time(end), 3)
        s.attrs["timing"] = "cuda_events"


class ShardClock:
    """Per-shard device time of one mesh dispatch (`shard_timer`): `start(i)`
    and `stop(i)` around shard i's work, on its device's compute stream."""

    def __init__(self, devices, mode: Optional[str]):
        self.devices = list(devices)
        self.mode = mode  # None (unsampled), "cuda_events" or "host"
        self._marks: Dict[int, list] = {}

    def start(self, i: int) -> None:
        self._mark(i, 0)

    def stop(self, i: int) -> None:
        self._mark(i, 1)

    def _mark(self, i: int, which: int) -> None:
        if self.mode is None:
            return
        marks = self._marks.setdefault(i, [None, None])
        if self.mode == "host":
            marks[which] = time.perf_counter()
            return
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.devices[i]))
        marks[which] = ev

    def shard_ms(self) -> List[float]:
        out = []
        for i in sorted(self._marks):
            a, b = self._marks[i]
            if self.mode == "host":
                out.append(round((b - a) * 1e3, 3))
            else:
                b.synchronize()
                out.append(round(a.elapsed_time(b), 3))
        return out


@contextlib.contextmanager
def shard_timer(devices):
    """Around one mesh dispatch: on a sampled query, each shard's device
    time (CUDA events on its device's compute stream on a card, its host
    time on the CPU), waited for after every shard was launched, in the
    enclosing span's attrs `shard_device_ms` (a list in shard order),
    `device_ms` (their sum) and `timing`.  Unsampled: nothing is recorded
    and nothing waits."""
    ps = _active.get()
    mode = None
    if ps is not None and ps.sampled:
        mode = "cuda_events" if all(_on_card(d) for d in devices) else "host"
    clock = ShardClock(devices, mode)
    t0 = time.perf_counter()
    yield clock
    if mode is None:
        return
    t1 = time.perf_counter()
    ms = clock.shard_ms()
    if mode == "cuda_events":
        _note_sync(ps)
    s = current_span()
    if s is not None:
        s.attrs.update(shard_device_ms=ms, device_ms=round(sum(ms), 3), timing=mode,
                       enqueue_ms=round((t1 - t0) * 1e3, 3))


def dispatch_sync(result, t_enqueue: float, device=None):
    """Right after an asynchronous dispatch on `device`, with the clock read
    before it.  On a sampled query: wait until the device finished
    (`torch.cuda.synchronize(device)` on a card; the CPU ran synchronously)
    and split the enclosing span into `enqueue_ms` and `device_ms`.
    Unsampled: nothing, no sync.  Returns `result`."""
    ps = _active.get()
    if ps is None or not ps.sampled:
        return result
    t1 = time.perf_counter()
    if _on_card(device):
        import torch

        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    _note_sync(ps)
    s = current_span()
    if s is not None:
        s.attrs["enqueue_ms"] = round((t1 - t_enqueue) * 1e3, 3)
        s.attrs["device_ms"] = round((t2 - t1) * 1e3, 3)
    return result


def fetch_sync(device) -> None:
    """Just before a blocking fetch: on a sampled query on a card, wait for
    the compute stream first, so the fetch span separates the wait on the
    card (`device_wait_ms`) from the copy.  No-op otherwise."""
    ps = _active.get()
    if ps is None or not ps.sampled or not _on_card(device):
        return
    import torch

    t0 = time.perf_counter()
    torch.cuda.current_stream(device).synchronize()
    _note_sync(ps)
    s = current_span()
    if s is not None:
        s.attrs["device_wait_ms"] = round((time.perf_counter() - t0) * 1e3, 3)


def transfer_sync(device) -> None:
    """After an h2d copy is issued: on a sampled query on a card, wait for
    it, so the caller's elapsed time is the link's, not the enqueue's.
    No-op otherwise (the unsampled measurement is the enqueue-observed
    effective rate, labelled by the receipt's `sampled`)."""
    ps = _active.get()
    if ps is None or not ps.sampled or not _on_card(device):
        return
    import torch

    torch.cuda.current_stream(device).synchronize()
    _note_sync(ps)


# ---------------------------------------------------------------------------
# Transfer / residency / program-cache accounting
# ---------------------------------------------------------------------------


def record_h2d(nbytes: int, seconds: float) -> None:
    """One host->device copy: effective MB/s into the link histogram
    (exemplared with the query id) and the scope's transfer
    accumulators."""
    ps = _active.get()
    mbps = nbytes / max(seconds, 1e-9) / 1e6
    get_registry().histogram(
        "sdol_h2d_link_mbps",
        "effective host->device link utilization per transfer (MB/s)",
        buckets=LINK_MBPS_BUCKETS,
    ).observe(mbps, exemplar=current_query_id() or None)
    if ps is not None:
        ps.transfer_ms += seconds * 1e3
        ps.transfer_bytes += int(nbytes)


def record_resident(datasource: str, bytes_now: int) -> None:
    """Publish a datasource's resident bytes."""
    ds = bounded_label("residency_datasource", datasource or "unknown")
    get_registry().gauge(
        "sdol_resident_bytes",
        "device-resident segment bytes, by datasource",
        labels=("datasource",),
    ).labels(datasource=ds).set(bytes_now)


def record_eviction(datasource: str, n: int = 1) -> None:
    ds = bounded_label("residency_datasource", datasource or "unknown")
    get_registry().counter(
        "sdol_residency_evictions_total",
        "residency-cache evictions under byte-budget pressure, "
        "by datasource",
        labels=("datasource",),
    ).labels(datasource=ds).inc(n)


def note_residency(hit: bool) -> None:
    ps = _active.get()
    if ps is None:
        return
    if hit:
        ps.residency_hits += 1
    else:
        ps.residency_misses += 1


def note_program_cache(family: str, hit: bool) -> None:
    """One program-cache lookup under its key family."""
    fam = bounded_label("program_family", family or "unknown")
    get_registry().counter(
        "sdol_program_cache_total",
        "compiled-program cache lookups, by tagged key family / outcome",
        labels=("family", "outcome"),
    ).labels(family=fam, outcome="hit" if hit else "miss").inc()
    ps = _active.get()
    if ps is not None:
        c = ps.program_cache.setdefault(family, [0, 0])
        c[0 if hit else 1] += 1
        if not hit:
            ps.pending_family = family


def note_compile(ms: float, family: Optional[str] = None) -> None:
    """The cost of one program build (on a card, a CUDA graph capture),
    attributed to the family whose cache miss triggered it (the scope
    remembers the last missed family when the caller cannot name it)."""
    ps = _active.get()
    if family is None and ps is not None:
        family = ps.pending_family
    fam = bounded_label("program_family", family or "unknown")
    reg = get_registry()
    reg.counter(
        "sdol_compiles_total",
        "program trace+compile events, by program-cache family",
        labels=("family",),
    ).labels(family=fam).inc()
    reg.counter(
        "sdol_compile_ms_total",
        "cumulative trace+compile milliseconds, by program-cache family",
        labels=("family",),
    ).labels(family=fam).inc(max(0.0, float(ms)))
    if ps is not None:
        ps.compiles += 1
        ps.compile_ms += max(0.0, float(ms))


def note_result_cache(outcome: str) -> None:
    ps = _active.get()
    if ps is not None:
        ps.result_cache = outcome


def note_fusion(batch: int) -> None:
    ps = _active.get()
    if ps is not None:
        ps.fused_batch = max(ps.fused_batch, int(batch))


def note_lane(lane: str) -> None:
    ps = _active.get()
    if ps is not None and lane:
        ps.lane = str(lane)


# ---------------------------------------------------------------------------
# Receipts
# ---------------------------------------------------------------------------


def _is_remote(node: dict) -> bool:
    """A grafted remote subtree's root (the broker's clock does not apply)."""
    return bool((node.get("attrs") or {}).get("remote"))


def _is_overlay(node: dict) -> bool:
    """Spans outside the local partition of the wall: concurrent replica
    attempts and grafted remote subtrees."""
    return str(node.get("name", "")) in CLUSTER_RPC_SPANS or _is_remote(node)


def _new_acc() -> Dict[str, Any]:
    return {
        "device": 0.0, "transfer": 0.0, "host": 0.0, "arena_build": 0.0,
        "unattributed": 0.0, "dispatch_count": 0, "events": 0.0, "timed": 0,
        "scatter": 0.0, "gather": 0.0, "cluster_merge": 0.0,
    }


def _walk_exclusive(node: dict, acc: Dict[str, float], depth: int) -> None:
    if _is_overlay(node):
        return  # folded per node by _walk_cluster_nodes
    dur = float(node.get("duration_ms", 0.0))
    children = [c for c in (node.get("children") or ()) if not _is_overlay(c)]
    child_sum = sum(float(c.get("duration_ms", 0.0)) for c in children)
    excl = max(0.0, dur - child_sum)
    name = str(node.get("name", ""))
    attrs = node.get("attrs") or {}
    if name in DISPATCH_SPANS:
        acc["dispatch_count"] += 1
    if attrs.get("timing") == "cuda_events":
        acc["events"] += float(attrs.get("device_ms", 0.0))
        acc["timed"] += 1
    if "shard_device_ms" in attrs:
        acc.setdefault("shards", []).append(list(attrs["shard_device_ms"]))
    if depth == 0 and name == ROOT_SPAN:
        acc["unattributed"] += excl
    elif name in DEVICE_SPANS:
        acc["device"] += excl
    elif name in TRANSFER_SPANS:
        acc["transfer"] += excl
    elif name in ARENA_SPANS:
        acc["arena_build"] += excl
    elif name in SCATTER_SPANS:
        acc["scatter"] += excl
    elif name in GATHER_SPANS:
        acc["gather"] += excl
    elif name in CLUSTER_MERGE_SPANS:
        acc["cluster_merge"] += excl
    else:
        acc["host"] += excl
    for c in children:
        _walk_exclusive(c, acc, depth + 1)


def _fold_remote_buckets(graft: dict) -> Dict[str, float]:
    """One grafted remote subtree's device, transfer and host time: its
    receipt (riding in the graft's root) when present, else the subtree
    folded through the same buckets (remote spans use the same names)."""
    rc = graft.get("receipt")
    if isinstance(rc, dict):
        return {
            "device_ms": float(rc.get("device_ms", 0.0) or 0.0),
            "transfer_ms": float(rc.get("transfer_ms", 0.0) or 0.0),
            "host_ms": float(rc.get("host_ms", 0.0) or 0.0),
            "remote_wall_ms": float(rc.get("wall_ms", 0.0) or 0.0),
        }
    acc = _new_acc()
    clean = dict(graft)
    attrs = dict(clean.get("attrs") or {})
    attrs.pop("remote", None)
    clean["attrs"] = attrs
    _walk_exclusive(clean, acc, 0)
    return {
        "device_ms": round(acc["device"], 3),
        "transfer_ms": round(acc["transfer"], 3),
        "host_ms": round(acc["host"], 3),
        "remote_wall_ms": float(graft.get("duration_ms", 0.0) or 0.0),
    }


def _node_bucket(nodes: Dict[str, Dict[str, Any]], nid: str) -> Dict[str, Any]:
    return nodes.setdefault(nid, {"ms": 0.0, "rpcs": 0, "ok": 0, "failed": 0, "segments": 0})


def _fold_rpc_span(c: dict, nodes: Dict[str, Dict[str, Any]]) -> None:
    """One `cluster_rpc` span into its node's bucket: the attempt's count,
    latency and outcome, and its grafted subtree's buckets.  `untraced`
    counts grafts that degraded to a stub (a receipt that came separately
    still folds)."""
    attrs = c.get("attrs") or {}
    b = _node_bucket(nodes, str(attrs.get("node", "?")))
    b["rpcs"] += 1
    ms = float(attrs.get("ms", c.get("duration_ms", 0.0)) or 0.0)
    b["ms"] = round(b["ms"] + ms, 3)
    if attrs.get("outcome") == "ok":
        b["ok"] += 1
        b["segments"] += int(attrs.get("segments", 0) or 0)
    else:
        b["failed"] += 1
    if attrs.get("hedge"):
        b["hedged"] = int(b.get("hedged", 0)) + 1
    for g in c.get("children") or ():
        if not _is_remote(g):
            continue
        if (g.get("attrs") or {}).get("untraced"):
            b["untraced"] = int(b.get("untraced", 0)) + 1
            if not isinstance(g.get("receipt"), dict):
                continue
        for k, v in _fold_remote_buckets(g).items():
            b[k] = round(float(b.get(k, 0.0)) + float(v), 3)


def _walk_cluster_nodes(node: dict, nodes: Dict[str, Dict[str, Any]]) -> None:
    """The scatter span's attempts (its `cluster_rpc` children), and its
    `rpc` events (a lost replica group marks itself so), into one bucket
    per historical the query touched: {node: {ms, rpcs, ok, failed,
    segments, device_ms, transfer_ms, host_ms, remote_wall_ms, ...}}."""
    if str(node.get("name", "")) in SCATTER_SPANS:
        for e in node.get("events") or ():
            if e.get("name") != "rpc":
                continue
            attrs = e.get("attrs") or {}
            b = _node_bucket(nodes, str(attrs.get("node", "?")))
            b["rpcs"] += 1
            b["ms"] = round(b["ms"] + float(attrs.get("ms", 0.0)), 3)
            if attrs.get("outcome") == "ok":
                b["ok"] += 1
                b["segments"] += int(attrs.get("segments", 0))
            else:
                b["failed"] += 1
        for c in node.get("children") or ():
            if str(c.get("name", "")) in CLUSTER_RPC_SPANS:
                _fold_rpc_span(c, nodes)
    for c in node.get("children") or ():
        if not _is_overlay(c):
            _walk_cluster_nodes(c, nodes)


def build_receipt(
    trace_doc: dict, scope: Optional[ProfScope] = None
) -> dict:
    """Fold one trace document (`QueryTrace.to_dict` shape) into a cost
    receipt.  A pure function of the document and the scope's counters,
    so it runs live (mid-query, provisional span ends) or at trace close.
    The JAX package's keys, plus `device_timing`: "cuda_events" when
    `device_ms` is the CUDA-event time of the query's sampled dispatches,
    "span" when it is the device spans' host time (enqueue time on a card,
    the work itself on the CPU)."""
    acc = _new_acc()
    cluster_nodes: Dict[str, Dict[str, Any]] = {}
    root = trace_doc.get("spans")
    if isinstance(root, dict):
        _walk_exclusive(root, acc, 0)
        _walk_cluster_nodes(root, cluster_nodes)
    wall = float(trace_doc.get("total_ms") or 0.0)
    timed = acc["timed"] > 0
    device = acc["events"] if timed else acc["device"]
    busy_stall = device + acc["transfer"]
    receipt: Dict[str, Any] = {
        "query_id": trace_doc.get("query_id", ""),
        "wall_ms": round(wall, 3),
        "device_ms": round(device, 3),
        "host_ms": round(acc["host"], 3),
        "transfer_ms": round(acc["transfer"], 3),
        # the port has no prefetch: the key stays, at zero
        "prefetch_ms": 0.0,
        "arena_build_ms": round(acc["arena_build"], 3),
        "unattributed_ms": round(acc["unattributed"], 3),
        "dispatch_count": int(acc["dispatch_count"]),
        "overlap_efficiency": (
            round(device / busy_stall, 4) if busy_stall > 0 else 1.0
        ),
        "sampled": bool(scope.sampled) if scope is not None else False,
        "device_timing": "cuda_events" if timed else "span",
    }
    if acc.get("shards"):
        # a sampled query on the mesh: each dispatch's per-shard device time
        receipt["shard_device_ms"] = acc["shards"]
    if cluster_nodes or acc["scatter"] or acc["gather"] or acc["cluster_merge"]:
        # a broker's query: the scatter, gather and merge buckets and one
        # bucket per historical (absent elsewhere, as in the reference)
        receipt["scatter_ms"] = round(acc["scatter"], 3)
        receipt["gather_ms"] = round(acc["gather"], 3)
        receipt["cluster_merge_ms"] = round(acc["cluster_merge"], 3)
        receipt["cluster"] = {"nodes": cluster_nodes}
    if scope is not None:
        cache: Dict[str, Any] = {
            "result_cache": scope.result_cache,
            "fused_batch": scope.fused_batch,
            "residency": {
                "hits": scope.residency_hits,
                "misses": scope.residency_misses,
            },
            "program_cache": {
                fam: {"hits": c[0], "misses": c[1]}
                for fam, c in sorted(scope.program_cache.items())
            },
        }
        receipt.update(
            transfer_bytes=scope.transfer_bytes,
            prefetch_bytes=0,
            transfer_mb_per_s=(
                round(
                    scope.transfer_bytes / max(scope.transfer_ms, 1e-9) / 1e3,
                    1,
                )
                if scope.transfer_bytes
                else 0.0
            ),
            compiles=scope.compiles,
            compile_ms=round(scope.compile_ms, 3),
            syncs=scope.syncs,
            lane=scope.lane,
            cache=cache,
        )
    return receipt


def live_receipt() -> Optional[dict]:
    """Receipt of the active query so far (unfinished spans measured to
    now under the tracer's clock): what df.attrs, QueryMetrics and the
    response-context header carry; the trace document gets the final
    recomputation at close.  None outside a trace."""
    tr = current_trace()
    if tr is None:
        return None
    try:
        return build_receipt(tr.to_dict_live(), _active.get())
    except Exception:  # attribution must never fail a query
        log.warning("live receipt build failed", exc_info=True)
        return None


# ---------------------------------------------------------------------------
# Workload profiler (GET /status/profile)
# ---------------------------------------------------------------------------


class WorkloadProfiler:
    """Process-wide rolling window of finished-query observations.  Like
    the metrics registry it outlives contexts; the tracer feeds it one
    observation per finished trace."""

    def __init__(self, capacity: int = 1024):
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=max(16, int(capacity)))

    def observe(self, trace_doc: dict, scope: Optional[ProfScope]) -> None:
        rc = trace_doc.get("receipt") or {}
        entry = {
            "t": time.monotonic(),
            "query_id": trace_doc.get("query_id", ""),
            "query_type": trace_doc.get("query_type", ""),
            "lane": (scope.lane if scope is not None else "") or "",
            "wall_ms": float(rc.get("wall_ms", trace_doc.get("total_ms", 0.0)) or 0.0),
            "device_ms": float(rc.get("device_ms", 0.0) or 0.0),
            "transfer_ms": float(rc.get("transfer_ms", 0.0) or 0.0),
            "compiles": int(rc.get("compiles", 0) or 0),
            "sampled": bool(rc.get("sampled", False)),
        }
        with self._lock:
            self._entries.append(entry)

    def window(self, window_s: float) -> List[dict]:
        cutoff = time.monotonic() - max(1e-3, float(window_s))
        with self._lock:
            return [e for e in self._entries if e["t"] >= cutoff]

    def profile(
        self,
        window_s: float = 300.0,
        top_k: int = 10,
        slo_ms: Optional[Dict[str, float]] = None,
    ) -> dict:
        """Rolling-window workload profile: top-K queries by device
        time, per-lane SLO burn-rate (fraction of the lane's queries
        whose wall exceeded its latency target), and window totals."""
        now = time.monotonic()
        entries = self.window(window_s)
        top = sorted(
            entries, key=lambda e: e["device_ms"], reverse=True
        )[: max(1, int(top_k))]
        lanes: Dict[str, dict] = {}
        for e in entries:
            lane = e["lane"] or "unclassified"
            d = lanes.setdefault(
                lane, {"queries": 0, "over_slo": 0, "wall_ms_sum": 0.0}
            )
            d["queries"] += 1
            d["wall_ms_sum"] += e["wall_ms"]
            target = (slo_ms or {}).get(lane)
            if target is not None and target > 0 and e["wall_ms"] > target:
                d["over_slo"] += 1
        for lane, d in lanes.items():
            target = (slo_ms or {}).get(lane)
            d["slo_ms"] = target
            d["burn_rate"] = (
                round(d["over_slo"] / d["queries"], 4)
                if d["queries"] and target
                else 0.0
            )
            d["mean_wall_ms"] = round(
                d["wall_ms_sum"] / max(1, d["queries"]), 3
            )
            del d["wall_ms_sum"]
        return {
            "window_s": float(window_s),
            "queries_observed": len(entries),
            "lanes": lanes,
            "top_device": [
                {
                    "query_id": e["query_id"],
                    "query_type": e["query_type"],
                    "lane": e["lane"] or "unclassified",
                    "device_ms": round(e["device_ms"], 3),
                    "wall_ms": round(e["wall_ms"], 3),
                    "sampled": e["sampled"],
                    "age_s": round(now - e["t"], 1),
                }
                for e in top
            ],
        }


_profiler: Optional[WorkloadProfiler] = None
_profiler_lock = threading.Lock()


def workload_profiler() -> WorkloadProfiler:
    global _profiler
    if _profiler is None:
        with _profiler_lock:
            if _profiler is None:
                _profiler = WorkloadProfiler()
    return _profiler


def _family_totals() -> Dict[str, dict]:
    """Per-program-family compile totals + hit/miss counts from the
    process registry (the /status/profile 'what is recompiling' table)."""
    reg = get_registry()
    out: Dict[str, dict] = {}
    for key, v in reg.counter(
        "sdol_program_cache_total",
        "compiled-program cache lookups, by tagged key family / outcome",
        labels=("family", "outcome"),
    ).snapshot().items():
        fam, _, outcome = key.partition(",")
        d = out.setdefault(
            fam, {"hits": 0, "misses": 0, "compiles": 0, "compile_ms": 0.0}
        )
        d["hits" if outcome == "hit" else "misses"] += int(v)
    for key, v in reg.counter(
        "sdol_compiles_total",
        "program trace+compile events, by program-cache family",
        labels=("family",),
    ).snapshot().items():
        out.setdefault(
            key, {"hits": 0, "misses": 0, "compiles": 0, "compile_ms": 0.0}
        )["compiles"] = int(v)
    for key, v in reg.counter(
        "sdol_compile_ms_total",
        "cumulative trace+compile milliseconds, by program-cache family",
        labels=("family",),
    ).snapshot().items():
        out.setdefault(
            key, {"hits": 0, "misses": 0, "compiles": 0, "compile_ms": 0.0}
        )["compile_ms"] = round(float(v), 3)
    return out


def profile_doc(
    config=None,
    top_k: Optional[int] = None,
    window_s: Optional[float] = None,
) -> dict:
    """The `GET /status/profile` document."""
    cfg = config
    k = int(top_k or getattr(cfg, "profile_top_k", 10) or 10)
    win = float(window_s or getattr(cfg, "profile_window_s", 300.0) or 300.0)
    slo = {
        "interactive": float(
            getattr(cfg, "lane_interactive_slo_ms", 0.0) or 0.0
        ),
        "heavy": float(getattr(cfg, "lane_heavy_slo_ms", 0.0) or 0.0),
    }
    doc = workload_profiler().profile(window_s=win, top_k=k, slo_ms=slo)
    doc["compile_families"] = _family_totals()
    plan = get_registry().counter(
        "sdol_plan_cache_total",
        "decoded-QuerySpec plan cache on the wire path, by outcome",
        labels=("outcome",),
    ).snapshot()
    doc["plan_cache"] = {k2 or "none": int(v) for k2, v in plan.items()}
    return doc
