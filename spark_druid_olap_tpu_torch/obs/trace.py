"""Per-query span tracing: the observability layer's timeline.

Druid lets a client set a `queryId` in the query context, echoes it back as
the `X-Druid-Query-Id` response header and tags its request logs with it.
A flat last-query `QueryMetrics` cannot answer "which concurrent query
retried?" or "where did this deadline expire?"; this module can:

  * **A span tree per query.**  A `QueryTrace` is rooted at a `query`
    span, with children for the lifecycle phases (`admission`, `lane`,
    `plan`, `execute`, `lower`, `h2d`, `segment_dispatch`,
    `device_fetch`, `finalize`, and `fallback`, `retry`, `degraded`,
    `partial` when a query leaves the plain path).  Span names come from
    the `SPAN_*` constants below, the JAX package's names for the layers
    the port has.
  * **A query_id from end to end.**  Born at the server (honouring
    Druid's `context.queryId`), carried by a contextvar through the
    engine, the tiers, the stream, resilience and the host fallback, and
    stamped on `QueryMetrics.query_id`.
  * **Instrumentation that costs nothing when idle.**  `span(name)` is one
    contextvar read when no trace is active; with a trace it is two clock
    reads and two list operations under a lock.  The clock is injectable,
    so tests count clock calls instead of timing wall-clock.
  * **A trace ring.**  Finished traces serialize to JSON and land in a
    bounded FIFO served by `GET /druid/v2/trace/{query_id}`.
  * **A slow-query log.**  A finished trace whose total reaches
    `SessionConfig.slow_query_ms` logs its rendered tree at WARNING.

Concurrency: the contextvars give every handler thread its own active trace
and span, so concurrent queries cannot interleave their trees; the
per-trace lock makes appends and finish safe if a span is opened from
another thread.  The stream's producer thread sees no trace (a new thread
starts with an empty context).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ..utils.log import get_logger

log = get_logger("obs.trace")


# ---------------------------------------------------------------------------
# Span-name registry: every `span(...)` call of the port names one of these
# (the JAX package's names for the layers the port has)
# ---------------------------------------------------------------------------

SPAN_QUERY = "query"  # root span of every trace
SPAN_ADMISSION = "admission"  # waiting for an admission slot
SPAN_PLAN = "plan"  # parse + plan (or plan-cache lookup)
SPAN_EXECUTE = "execute"  # device/fallback execution umbrella
SPAN_LOWER = "lower"  # query lowering + segment scoping
SPAN_H2D = "h2d"  # host->device copies of a scope's cold columns
SPAN_SEGMENT_DISPATCH = "segment_dispatch"  # a scope's segment work: a graph replay or the eager loop
SPAN_DEVICE_FETCH = "device_fetch"  # blocking host fetch of partials
SPAN_FINALIZE = "finalize"  # host-side result materialization
SPAN_FALLBACK = "fallback"  # host interpreter run
SPAN_FALLBACK_DECODE = "fallback_decode"  # fallback table materialization
SPAN_RETRY = "retry"  # one transient-failure re-attempt
SPAN_DEGRADED = "degraded"  # breaker/failure degradation to the fallback
SPAN_SPARSE_DISPATCH = "sparse_dispatch"  # sort-compaction tier dispatch
SPAN_ADAPTIVE_PROBE = "adaptive_probe"  # adaptive presence pass
SPAN_COLLECTIVE_MERGE = "collective_merge"  # mesh shards' dispatch and the merge of their states
SPAN_STREAM_CHUNK = "stream_chunk"  # one streaming chunk dispatch
SPAN_PARTIAL = "partial"  # deadline-bounded best-effort answer (coverage)
SPAN_STREAM_FLUSH = "stream_flush"  # one progressive-response refinement
SPAN_FUSED_BATCH = "fused_batch"  # one micro-batch fused execution (serve/)
SPAN_LANE = "lane"  # waiting for a priority-lane slot (serve/lanes.py)
SPAN_ARENA_BUILD = "arena_build"  # a CUDA graph capture of a scope or a fused batch (exec/arena.py)
SPAN_INGEST = "ingest"  # one streamed append (ingest/delta.py)
SPAN_INGEST_ENCODE = "ingest_encode"  # dictionary extension, remap and encode of an append batch
SPAN_ROLLUP = "rollup"  # ingest-time pre-aggregation of an append batch
SPAN_COMPACT = "compact"  # delta -> historical roll of one datasource (ingest/compact.py)
SPAN_WAL_APPEND = "wal_append"  # fsync'd journal write of one append batch (storage.py)
SPAN_WAL_REPLAY = "wal_replay"  # boot-time recovery of one datasource: snapshot load and WAL replay
SPAN_SNAPSHOT_FLUSH = "snapshot_flush"  # one persistent snapshot commit
SPAN_SCATTER = "scatter"  # broker: the replica fetches in flight (cluster/)
SPAN_GATHER = "gather"  # broker: the merge of the gathered replica states
SPAN_CLUSTER_MERGE = "cluster_merge"  # broker: one replica state merged in
SPAN_CLUSTER_RPC = "cluster_rpc"  # broker: one replica attempt (a pool thread's)

SPAN_NAMES = frozenset(
    {
        SPAN_QUERY,
        SPAN_ADMISSION,
        SPAN_PLAN,
        SPAN_EXECUTE,
        SPAN_LOWER,
        SPAN_H2D,
        SPAN_SEGMENT_DISPATCH,
        SPAN_DEVICE_FETCH,
        SPAN_FINALIZE,
        SPAN_FALLBACK,
        SPAN_FALLBACK_DECODE,
        SPAN_RETRY,
        SPAN_DEGRADED,
        SPAN_SPARSE_DISPATCH,
        SPAN_ADAPTIVE_PROBE,
        SPAN_COLLECTIVE_MERGE,
        SPAN_STREAM_CHUNK,
        SPAN_PARTIAL,
        SPAN_STREAM_FLUSH,
        SPAN_FUSED_BATCH,
        SPAN_LANE,
        SPAN_ARENA_BUILD,
        SPAN_INGEST,
        SPAN_INGEST_ENCODE,
        SPAN_ROLLUP,
        SPAN_COMPACT,
        SPAN_WAL_APPEND,
        SPAN_WAL_REPLAY,
        SPAN_SNAPSHOT_FLUSH,
        SPAN_SCATTER,
        SPAN_GATHER,
        SPAN_CLUSTER_MERGE,
        SPAN_CLUSTER_RPC,
    }
)


def new_query_id() -> str:
    """Druid-shaped opaque query id (uuid4, the broker's own format)."""
    return str(uuid.uuid4())


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


class Span:
    """One timed phase.  Start and end are tracer-clock readings (seconds);
    `attrs` carry small JSON-able facts (segment counts, a retry attempt,
    device time from CUDA events on a sampled query); `events` are
    point-in-time observations inside the phase (the breaker state read at
    routing time): a name, a clock reading and small attrs, without a child
    span.

    `grafts` hold rendered remote subtrees: a historical's span tree,
    spliced under the broker's `cluster_rpc` span when the tree renders.  A
    graft keeps its remote clock (its `start_ms` counts from the remote
    root: two processes' clocks do not join) and carries `attrs.remote`."""

    __slots__ = ("name", "start", "end", "attrs", "children", "events", "grafts")

    def __init__(self, name: str, start: float, attrs: Optional[dict] = None):
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs or {}
        self.children: List["Span"] = []
        self.events: List[Dict[str, Any]] = []
        self.grafts: List[dict] = []

    @property
    def duration_ms(self) -> float:
        if self.end is None:
            return 0.0
        return (self.end - self.start) * 1e3

    def to_dict(self, origin: float, now: Optional[float] = None) -> dict:
        # `now` serves live snapshots (obs/prof.live_receipt builds a
        # receipt mid-query): an unfinished span measures to the
        # provisional clock reading instead of reporting zero
        dur = self.duration_ms
        if self.end is None and now is not None:
            dur = (now - self.start) * 1e3
        d: Dict[str, Any] = {
            "name": self.name,
            "start_ms": round((self.start - origin) * 1e3, 3),
            "duration_ms": round(dur, 3),
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.events:
            d["events"] = [
                {
                    "name": e["name"],
                    "at_ms": round((e["at"] - origin) * 1e3, 3),
                    **({"attrs": dict(e["attrs"])} if e["attrs"] else {}),
                }
                for e in self.events
            ]
        if self.children or self.grafts:
            d["children"] = [c.to_dict(origin, now) for c in self.children] + list(self.grafts)
        return d


class QueryTrace:
    """The span tree of one query, rooted at a `query` span."""

    def __init__(
        self,
        query_id: str,
        clock: Callable[[], float] = time.perf_counter,
        query_type: str = "",
    ):
        self.query_id = query_id
        self.query_type = query_type
        self._clock = clock
        self._lock = threading.Lock()
        self.root = Span(SPAN_QUERY, clock())
        # the query's cost receipt (obs/prof.py), stamped at trace close;
        # it rides every to_dict, so the ring's document and
        # /druid/v2/trace/{id} carry it
        self.receipt: Optional[dict] = None
        # the broker's span id when a historical serves a broker's attempt:
        # the OTLP export then joins both processes into one tree
        self.parent_span_id: str = ""

    def start_span(
        self, name: str, parent: Optional[Span], attrs: Optional[dict] = None
    ) -> Span:
        """Internal pairing API: instrumented code goes through the
        `span(...)` context manager, which closes the span on every early
        return or raise."""
        s = Span(name, self._clock(), attrs)
        with self._lock:
            (parent or self.root).children.append(s)
        return s

    def end_span(self, s: Span) -> None:
        s.end = self._clock()

    def add_event(
        self, s: Span, name: str, attrs: Optional[dict] = None
    ) -> None:
        with self._lock:
            s.events.append(
                {"name": name, "at": self._clock(), "attrs": attrs or {}}
            )

    def graft(self, s: Span, subtree: dict) -> None:
        """Splice a rendered remote subtree (a historical's
        `to_dict()["spans"]`, or an `untraced` stub) under `s`; the scatter's
        pool threads graft concurrently, so under the trace's lock."""
        with self._lock:
            s.grafts.append(subtree)

    def finish(self) -> None:
        with self._lock:
            if self.root.end is None:
                self.root.end = self._clock()

    @property
    def total_ms(self) -> float:
        return self.root.duration_ms

    def to_dict(self) -> dict:
        d = {
            "query_id": self.query_id,
            "query_type": self.query_type,
            "total_ms": round(self.total_ms, 3),
            "spans": self.root.to_dict(self.root.start),
        }
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        if self.receipt is not None:
            d["receipt"] = self.receipt
        return d

    def to_dict_live(self) -> dict:
        """Provisional snapshot of a trace still in flight: unfinished
        spans (the root among them) measure to now under the tracer's own
        clock; what obs.prof.live_receipt folds into the receipt that the
        response header and df.attrs carry."""
        now = self._clock()
        root_end = self.root.end if self.root.end is not None else now
        return {
            "query_id": self.query_id,
            "query_type": self.query_type,
            "total_ms": round((root_end - self.root.start) * 1e3, 3),
            "spans": self.root.to_dict(self.root.start, now),
        }

    def render(self) -> str:
        """Indented phase/latency lines (the slow-query log's body)."""
        lines: List[str] = []

        def walk(s: Span, depth: int) -> None:
            attrs = (
                " " + " ".join(f"{k}={v}" for k, v in sorted(s.attrs.items()))
                if s.attrs
                else ""
            )
            lines.append(
                f"{'  ' * depth}{s.name:<20} {s.duration_ms:>9.2f}ms{attrs}"
            )
            for e in s.events:
                eattrs = " ".join(
                    f"{k}={v}" for k, v in sorted(e["attrs"].items())
                )
                lines.append(
                    f"{'  ' * (depth + 1)}@ {e['name']}"
                    f"{' ' + eattrs if eattrs else ''}"
                )
            for c in s.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Active-trace plumbing (contextvars: per-thread/per-context isolation)
# ---------------------------------------------------------------------------

_active_trace: contextvars.ContextVar[Optional[QueryTrace]] = (
    contextvars.ContextVar("sdol_torch_active_trace", default=None)
)
_active_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "sdol_torch_active_span", default=None
)


def current_trace() -> Optional[QueryTrace]:
    return _active_trace.get()


def current_query_id() -> str:
    tr = _active_trace.get()
    return tr.query_id if tr is not None else ""


def current_span() -> Optional[Span]:
    """The innermost open span of the active trace (None without one):
    where the sampled device timing writes its attrs."""
    return _active_span.get()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a child span of the active trace; a no-op (one contextvar
    read) when no trace is active.  The way instrumented code creates
    spans: the context manager owns the pairing, so every early return
    and raise closes the span."""
    tr = _active_trace.get()
    if tr is None:
        yield None
        return
    s = tr.start_span(name, _active_span.get(), attrs or None)
    token = _active_span.set(s)
    try:
        yield s
    finally:
        _active_span.reset(token)
        tr.end_span(s)


@contextlib.contextmanager
def span_in(trace: Optional[QueryTrace], parent: Optional[Span], name: str, **attrs):
    """A span on an explicit trace handle under an explicit parent: for pool
    threads, which see no active trace (a new thread starts with an empty
    context).  The broker's scatter workers (`cluster/broker.py`) pass
    (trace, scatter span) here, so every replica attempt gets its own
    `cluster_rpc` span.  Owns the pairing as `span(...)` does; a no-op when
    `trace` is None."""
    if trace is None:
        yield None
        return
    s = trace.start_span(name, parent, attrs or None)
    try:
        yield s
    finally:
        trace.end_span(s)


def span_event(name: str, **attrs) -> None:
    """Attach a point-in-time event to the active span (no child span, no
    duration): the routing layer records the breaker state it observed,
    the fusion scheduler its window decision.  A no-op (one contextvar
    read) when no trace is active."""
    tr = _active_trace.get()
    if tr is None:
        return
    s = _active_span.get()
    tr.add_event(s if s is not None else tr.root, name, attrs or None)


# ---------------------------------------------------------------------------
# Ring buffer + tracer
# ---------------------------------------------------------------------------


class TraceRing:
    """Bounded FIFO of finished traces, keyed by query_id.  A repeated
    query_id overwrites in place (Druid lets clients reuse ids); capacity
    evicts the oldest insertion."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()

    def put(self, trace_dict: dict) -> None:
        qid = trace_dict.get("query_id", "")
        with self._lock:
            if qid in self._traces:
                self._traces.pop(qid)
            self._traces[qid] = trace_dict
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def get(self, query_id: str) -> Optional[dict]:
        with self._lock:
            return self._traces.get(query_id)

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class Tracer:
    """Owns the clock, the finished-trace ring and the trace lifecycle.

    `clock` is injectable so tests count clock calls instead of timing
    wall-clock; a TPUOlapContext builds its tracer with the ring capacity
    `SessionConfig.trace_ring_capacity`, the OTLP file
    `otlp_export_path` and the sampling rate `prof_sample_rate`."""

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        capacity: int = 64,
        otlp_path: Optional[str] = None,
        prof_sample_rate: float = 0.0,
    ):
        self.clock = clock
        self.ring = TraceRing(capacity)
        self.last: Optional[QueryTrace] = None
        # emit-only OTLP export: finished trace documents append, one
        # ResourceSpans line each, to this path
        self.otlp_path = otlp_path
        # every owned trace arms a ProfScope; the sampler decides which
        # queries pay the sampled device timing (CUDA events and their
        # syncs).  Deterministic (no RNG) and force-armable
        # (`force_sample_next`)
        from .prof import RateSampler

        self.sampler = RateSampler(prof_sample_rate)

    def force_sample_next(self) -> None:
        """Arm sampled device timing for the next owned trace whatever the
        configured rate."""
        self.sampler.force_next()

    @contextlib.contextmanager
    def query_trace(
        self,
        query_id: Optional[str] = None,
        query_type: str = "",
        slow_ms: float = 0.0,
        parent_span_id: str = "",
    ):
        """Open (or join) the per-query trace.  The outermost scope wins,
        as with `resilience.deadline_scope`: the server starts the trace
        and `ctx.sql` inside it joins instead of nesting a second root.
        `parent_span_id` stamps a parent in another process (a historical's
        trace opened under a broker's attempt)."""
        existing = _active_trace.get()
        if existing is not None:
            yield existing
            return
        from . import prof as _prof

        tr = QueryTrace(
            query_id or new_query_id(), clock=self.clock,
            query_type=query_type,
        )
        if parent_span_id:
            tr.parent_span_id = str(parent_span_id)
        tok_t = _active_trace.set(tr)
        tok_s = _active_span.set(tr.root)
        ps = _prof.ProfScope(sampled=self.sampler.take())
        tok_p = _prof.activate(ps)
        try:
            yield tr
        finally:
            _active_span.reset(tok_s)
            _active_trace.reset(tok_t)
            tr.finish()
            self.last = tr
            doc = tr.to_dict()
            # the query's cost receipt: the finished span tree and the
            # prof scope's counters folded into the attribution document,
            # which also feeds the rolling workload profiler; neither may
            # fail a query
            try:
                tr.receipt = _prof.build_receipt(doc, ps)
                doc["receipt"] = tr.receipt
                _prof.workload_profiler().observe(doc, ps)
            except Exception:  # attribution must not fail a query
                log.warning("receipt build failed", exc_info=True)
            _prof.deactivate(tok_p)
            self.ring.put(doc)
            if self.otlp_path:
                from .otlp import append_otlp

                try:
                    append_otlp(self.otlp_path, doc)
                except OSError:  # the export must never fail a query
                    log.warning(
                        "OTLP export to %s failed", self.otlp_path,
                        exc_info=True,
                    )
            if slow_ms and slow_ms > 0 and tr.total_ms >= slow_ms:
                log.warning(
                    "slow query %s: %.1fms >= %.0fms threshold\n%s",
                    tr.query_id, tr.total_ms, slow_ms, tr.render(),
                )

    def last_trace_dict(self) -> Optional[dict]:
        return self.last.to_dict() if self.last is not None else None


_default_tracer: Optional[Tracer] = None
_default_tracer_lock = threading.Lock()


def default_tracer() -> Tracer:
    """Process-default tracer for code outside a TPUOlapContext (direct
    Engine use, tooling)."""
    global _default_tracer
    if _default_tracer is None:
        with _default_tracer_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer
