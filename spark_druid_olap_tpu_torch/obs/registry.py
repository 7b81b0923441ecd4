"""Process-wide metrics registry with Prometheus text exposition.

Druid nodes emit query, segment and JVM metrics through pluggable
emitters, and deployments scrape them as Prometheus series; the analog
here is one process-global `MetricsRegistry` every layer publishes into:
the engine (query counts by type, executor and outcome, per-phase latency
histograms, h2d bytes), the resilience layer (retries, breaker
transitions, admission and lane queue depth), the serving core (result
cache, plan cache, program cache and graph captures) and the HTTP server
(requests by route and code).  It renders at `GET /status/metrics` in
Prometheus text format and is summarized (histogram p50/p95/p99) inside
`GET /status`.  Family names, label sets and histogram buckets are the
JAX package's, so a scrape of either package reads the same way.

The registry is deliberately PROCESS-wide, not per-context: a scrape
must see the whole process exactly like a real exporter would, and
counters must be monotonic across context rebuilds.  Everything is
lock-guarded; label sets are fixed at family registration so exposition
stays stable.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# per-phase latency buckets, ms: spans sub-ms cached-program queries up
# through minutes-long SF100 scans
DEFAULT_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
)


def _escape_label(v: str) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Family:
    """One metric family: fixed name, help, label names; children keyed
    by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labels: Tuple[str, ...]):
        self.name = name
        self.help = help_text
        self.label_names = labels
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child_key(self, kwargs: Dict[str, str]) -> Tuple[str, ...]:
        if set(kwargs) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {sorted(kwargs)}"
            )
        return tuple(str(kwargs[n]) for n in self.label_names)


class Counter(_Family):
    """Monotonic counter family.  Unlabeled families use `.inc()` on the
    family itself (a single implicit child)."""

    kind = "counter"

    def labels(self, **kwargs) -> "Counter._Child":
        key = self._child_key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Counter._Child(self)
        return child  # type: ignore[return-value]

    def inc(self, amount: float = 1.0) -> None:
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled; use .labels(...).inc()"
            )
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        if self.label_names:
            raise ValueError(f"metric {self.name!r} is labeled")
        return self.labels().value

    class _Child:
        __slots__ = ("_family", "_value")

        def __init__(self, family: "Counter"):
            self._family = family
            self._value = 0.0

        def inc(self, amount: float = 1.0) -> None:
            if amount < 0:
                raise ValueError("counters only go up")
            with self._family._lock:
                self._value += amount

        @property
        def value(self) -> float:
            with self._family._lock:
                return self._value

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
            return [
                f"{self.name}{_fmt_labels(self.label_names, key)} "
                f"{child._value:g}"
                for key, child in items
            ]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {
                ",".join(key) if key else "": child._value
                for key, child in self._children.items()
            }


class Gauge(_Family):
    """Settable gauge; `set_function` installs a live callback (read at
    render time) — how the admission pool exposes queue depth without a
    write on every acquire/release."""

    kind = "gauge"

    def __init__(self, name, help_text, labels):
        super().__init__(name, help_text, labels)
        self._fn: Optional[Callable[[], float]] = None

    def labels(self, **kwargs) -> "Gauge._Child":
        key = self._child_key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Gauge._Child(self)
        return child  # type: ignore[return-value]

    def set(self, value: float) -> None:
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled; use .labels(...).set()"
            )
        self.labels().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Callback gauge (unlabeled): re-binding replaces the previous
        callback, so a rebuilt context simply takes over the series."""
        if self.label_names:
            raise ValueError("callback gauges are unlabeled")
        with self._lock:
            self._fn = fn

    class _Child:
        __slots__ = ("_family", "_value", "_fn")

        def __init__(self, family: "Gauge"):
            self._family = family
            self._value = 0.0
            self._fn: Optional[Callable[[], float]] = None

        def set(self, value: float) -> None:
            with self._family._lock:
                self._value = float(value)

        def set_function(self, fn: Callable[[], float]) -> None:
            """Per-series live callback (read at render time) — how the
            per-backend breakers export `sdol_breaker_state{backend=...}`
            without writing a gauge on every state transition.
            Re-binding replaces the callback (a rebuilt context takes
            over its series)."""
            with self._family._lock:
                self._fn = fn

        def _read(self) -> float:
            with self._family._lock:
                fn, v = self._fn, self._value
            if fn is None:
                return v
            try:
                return float(fn())
            except Exception:  # fault-ok: dead callback must not break a scrape
                return v

        @property
        def value(self) -> float:
            return self._read()

    def _read_fn(self) -> Optional[float]:
        with self._lock:
            fn = self._fn
        if fn is None:
            return None
        try:
            return float(fn())
        except Exception:  # fault-ok: a dead callback must not break a scrape
            return None

    def render(self) -> List[str]:
        v = self._read_fn()
        if v is not None:
            return [f"{self.name} {v:g}"]
        with self._lock:
            items = sorted(self._children.items())
        return [
            f"{self.name}{_fmt_labels(self.label_names, key)} "
            f"{child._read():g}"
            for key, child in items
        ]

    def snapshot(self) -> Dict[str, float]:
        v = self._read_fn()
        if v is not None:
            return {"": v}
        with self._lock:
            items = list(self._children.items())
        return {
            ",".join(key) if key else "": child._read()
            for key, child in items
        }


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics: `le` buckets,
    `_sum`, `_count`) with quantile estimation for the JSON summary."""

    kind = "histogram"

    def __init__(self, name, help_text, labels, buckets=DEFAULT_BUCKETS_MS):
        super().__init__(name, help_text, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def labels(self, **kwargs) -> "Histogram._Child":
        key = self._child_key(kwargs)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Histogram._Child(self)
        return child  # type: ignore[return-value]

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled; use .labels(...).observe()"
            )
        self.labels().observe(value, exemplar=exemplar)

    class _Child:
        __slots__ = ("_family", "counts", "sum", "count", "exemplars")

        def __init__(self, family: "Histogram"):
            self._family = family
            self.counts = [0] * len(family.buckets)
            self.sum = 0.0
            self.count = 0
            # per-native-bucket exemplar: the last (trace_id, value)
            # observed in that bucket, +1 slot for the +Inf overflow:
            # the one-hop link from "the p99 bucket is hot" to the query
            # trace that landed there
            self.exemplars: List[Optional[Tuple[str, float]]] = (
                [None] * (len(family.buckets) + 1)
            )

        def observe(
            self, value: float, exemplar: Optional[str] = None
        ) -> None:
            v = float(value)
            with self._family._lock:
                self.sum += v
                self.count += 1
                native = len(self._family.buckets)
                for i, b in enumerate(self._family.buckets):
                    if v <= b:
                        self.counts[i] += 1
                        native = min(native, i)
                if exemplar:
                    self.exemplars[native] = (str(exemplar), v)

        def quantile(self, q: float) -> Optional[float]:
            """Bucket-interpolated quantile; None when empty.  Values past
            the last bucket clamp to it (the honest answer a bounded
            histogram can give)."""
            with self._family._lock:
                total = self.count
                if total == 0:
                    return None
                rank = q * total
                prev_cum = 0
                prev_edge = 0.0
                for edge, cum in zip(self._family.buckets, self.counts):
                    if cum >= rank:
                        in_bucket = cum - prev_cum
                        if in_bucket <= 0:
                            return edge
                        frac = (rank - prev_cum) / in_bucket
                        return prev_edge + frac * (edge - prev_edge)
                    prev_cum, prev_edge = cum, edge
                return self._family.buckets[-1]

    def render(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            items = sorted(self._children.items())
            for key, child in items:
                for i, (edge, cum) in enumerate(
                    zip(self.buckets, child.counts)
                ):
                    lbls = _fmt_labels(
                        self.label_names + ("le",), key + (f"{edge:g}",)
                    )
                    out.append(f"{self.name}_bucket{lbls} {cum}")
                    ex = child.exemplars[i]
                    if ex is not None:
                        # exemplar as a comment line: the 0.0.4 text
                        # format has no native exemplar syntax and
                        # scrapers skip comments, so the trace link
                        # rides along without breaking any parser
                        out.append(
                            f"# exemplar {self.name}_bucket{lbls} "
                            f'trace_id="{_escape_label(ex[0])}" '
                            f"value={ex[1]:g}"
                        )
                lbls = _fmt_labels(
                    self.label_names + ("le",), key + ("+Inf",)
                )
                out.append(f"{self.name}_bucket{lbls} {child.count}")
                ex = child.exemplars[-1]
                if ex is not None:
                    out.append(
                        f"# exemplar {self.name}_bucket{lbls} "
                        f'trace_id="{_escape_label(ex[0])}" '
                        f"value={ex[1]:g}"
                    )
                base = _fmt_labels(self.label_names, key)
                out.append(f"{self.name}_sum{base} {child.sum:g}")
                out.append(f"{self.name}_count{base} {child.count}")
        return out

    def snapshot(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        with self._lock:
            # one acquisition: children plus their exemplar slots (the
            # quantile calls below take the lock themselves, so they
            # stay outside it)
            items = [
                (key, child, list(child.exemplars))
                for key, child in self._children.items()
            ]
        for key, child, exemplar_slots in items:
            entry = {
                "count": child.count,
                "sum_ms": round(child.sum, 3),
                "p50": child.quantile(0.50),
                "p95": child.quantile(0.95),
                "p99": child.quantile(0.99),
            }
            exemplars = {
                (f"{self.buckets[i]:g}" if i < len(self.buckets)
                 else "+Inf"): {"trace_id": ex[0], "value": ex[1]}
                for i, ex in enumerate(exemplar_slots)
                if ex is not None
            }
            if exemplars:
                entry["exemplars"] = exemplars
            out[",".join(key) if key else ""] = entry
        return out


class MetricsRegistry:
    """Name -> family table.  Registration is idempotent for identical
    (kind, labels) declarations — every subsystem declares what it
    publishes and the first declaration wins the help text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "Dict[str, _Family]" = {}

    def _register(self, cls, name, help_text, labels, **kw) -> _Family:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}"
                    )
                return fam
            fam = cls(name, help_text, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help_text: str = "", labels: Iterable[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help_text, labels)  # type: ignore[return-value]

    def gauge(
        self, name: str, help_text: str = "", labels: Iterable[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help_text, labels)  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labels: Iterable[str] = (),
        buckets: Iterable[float] = DEFAULT_BUCKETS_MS,
    ) -> Histogram:
        return self._register(
            Histogram, name, help_text, labels, buckets=tuple(buckets)
        )  # type: ignore[return-value]

    # -- exposition -----------------------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.items())
        for name, fam in fams:
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def to_dict(self) -> dict:
        """JSON summary for `/status`: counter/gauge values plus
        histogram p50/p95/p99."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = sorted(self._families.items())
        for name, fam in fams:
            out[name] = {"type": fam.kind, "values": fam.snapshot()}
        return out


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


# ---------------------------------------------------------------------------
# Label-cardinality guard
# ---------------------------------------------------------------------------

# free-form label values (datasource names arrive from clients) past the
# cap collapse into one overflow bucket: a hostile name-per-request stream
# can grow the registry by at most `cap` children per family
LABEL_OVERFLOW = "__other__"

_label_guard_lock = threading.Lock()
_label_seen: Dict[str, set] = {}


def bounded_label(family: str, value: str, cap: int = 64) -> str:
    """Admit `value` as a label for `family` while the family's distinct
    admitted set stays under `cap`; return LABEL_OVERFLOW otherwise.
    First-come-first-admitted and process-global (series must stay
    stable across context rebuilds, like the registry itself)."""
    v = str(value) if value else "unknown"
    with _label_guard_lock:
        seen = _label_seen.get(family)
        if seen is None:
            seen = _label_seen[family] = set()
        if v in seen:
            return v
        if len(seen) >= max(1, int(cap)):
            return LABEL_OVERFLOW
        seen.add(v)
        return v


# ---------------------------------------------------------------------------
# The process metric catalog (engines + resilience publish through these)
# ---------------------------------------------------------------------------


def record_partial(coverage, site: str = "", query_id: str = "") -> None:
    """Publish one deadline-bounded PARTIAL answer: a count by triggering
    site plus the coverage-fraction distribution.
    The coverage histogram is the fleet-level answer to "how much of the
    data do deadline-bounded dashboards actually see?"; the query_id
    rides along as the bucket exemplar, same as the latency series."""
    reg = get_registry()
    reg.counter(
        "sdol_partial_results_total",
        "queries answered with deadline-bounded partial results, by "
        "triggering checkpoint site",
        labels=("site",),
    ).labels(site=bounded_label("partial_site", site or "unknown")).inc()
    if coverage is not None:
        reg.histogram(
            "sdol_partial_coverage",
            "coverage fraction of deadline-bounded partial answers",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0),
        ).observe(float(coverage), exemplar=query_id or None)


def record_query_metrics(m, outcome: str = "ok") -> None:
    """Publish one finished execution's `QueryMetrics` into the process
    registry: the engine calls this from its metrics-finish path, the api
    layer for fallback runs and result-cache hits."""
    if m is None:
        return
    reg = get_registry()
    reg.counter(
        "sdol_queries_total",
        "queries executed, by wire type / executor / outcome",
        labels=("query_type", "executor", "outcome"),
    ).labels(
        query_type=m.query_type or "unknown",
        executor=m.executor or "unknown",
        outcome=outcome,
    ).inc()
    # per-datasource traffic: which table is hot is the first question a
    # dashboard fleet asks; the guard caps the series a client-controlled
    # name stream can mint
    ds_name = getattr(m, "datasource", "") or None
    if ds_name:
        reg.counter(
            "sdol_datasource_queries_total",
            "queries executed, by datasource / wire type",
            labels=("datasource", "query_type"),
        ).labels(
            datasource=bounded_label("query_datasource", ds_name),
            query_type=m.query_type or "unknown",
        ).inc()
    if m.retries:
        reg.counter(
            "sdol_query_retries_total",
            "transient-failure re-dispatches paid by queries",
        ).inc(m.retries)
    if m.rows_scanned:
        reg.counter(
            "sdol_rows_scanned_total", "rows scanned by query kernels"
        ).inc(m.rows_scanned)
    if m.h2d_bytes:
        reg.counter(
            "sdol_h2d_bytes_total",
            "bytes moved host->device on residency-cache misses",
        ).inc(m.h2d_bytes)
    hist = reg.histogram(
        "sdol_query_phase_ms",
        "per-phase query latency (ms)",
        labels=("phase",),
    )
    # the query_id rides along as the bucket's exemplar, linking the
    # latency distribution back to a concrete trace in the ring
    qid = getattr(m, "query_id", "") or None
    for phase, value in (
        ("h2d", m.h2d_ms),
        ("compile", m.capture_ms),  # a graph capture is the port's compile
        ("device", m.device_ms),
        ("finalize", m.finalize_ms),
        ("total", m.total_ms),
    ):
        if value > 0 or phase == "total":
            hist.labels(phase=phase).observe(value, exemplar=qid)


# -- ingest and storage (ingest/, storage.py, catalog/persist.py) ---------------


def record_ingest(datasource: str, rows: int, outcome: str = "ok") -> None:
    """Publish one streamed append: request count by datasource/outcome
    plus appended rows — per-datasource labels ride through the
    cardinality guard (a hostile datasource-name stream cannot explode
    the registry)."""
    reg = get_registry()
    ds = bounded_label("ingest_datasource", datasource)
    reg.counter(
        "sdol_ingest_requests_total",
        "streamed ingest appends, by datasource / outcome",
        labels=("datasource", "outcome"),
    ).labels(datasource=ds, outcome=outcome).inc()
    if rows:
        reg.counter(
            "sdol_ingest_rows_total",
            "rows appended through the streamed ingest tier",
            labels=("datasource",),
        ).labels(datasource=ds).inc(rows)


def record_compaction(datasource: str, rows: int, delta_segments: int) -> None:
    """Publish one delta->historical compaction."""
    reg = get_registry()
    ds = bounded_label("ingest_datasource", datasource)
    reg.counter(
        "sdol_compactions_total",
        "delta->historical compactions, by datasource",
        labels=("datasource",),
    ).labels(datasource=ds).inc()
    if rows:
        reg.counter(
            "sdol_compacted_rows_total",
            "delta rows rolled into historical segments",
            labels=("datasource",),
        ).labels(datasource=ds).inc(rows)
    if delta_segments:
        reg.counter(
            "sdol_compacted_delta_segments_total",
            "delta segments consumed by compaction",
            labels=("datasource",),
        ).labels(datasource=ds).inc(delta_segments)


def record_wal_append(datasource: str, rows: int) -> None:
    """Publish one durable WAL journal write (storage.py):
    acked appends are exactly the journaled ones, so this series is the
    durability-side mirror of `sdol_ingest_rows_total`."""
    reg = get_registry()
    ds = bounded_label("ingest_datasource", datasource)
    reg.counter(
        "sdol_wal_appends_total",
        "fsync'd WAL journal writes, by datasource",
        labels=("datasource",),
    ).labels(datasource=ds).inc()
    if rows:
        reg.counter(
            "sdol_wal_rows_total",
            "rows journaled to the append WAL",
            labels=("datasource",),
        ).labels(datasource=ds).inc(rows)


def record_wal_replay(datasource: str, records: int, rows: int) -> None:
    """Publish one boot-time WAL replay (records past the snapshot
    watermark re-applied through the live append path)."""
    reg = get_registry()
    ds = bounded_label("ingest_datasource", datasource)
    reg.counter(
        "sdol_wal_replays_total",
        "boot-time WAL replay passes, by datasource",
        labels=("datasource",),
    ).labels(datasource=ds).inc()
    if records:
        reg.counter(
            "sdol_wal_replayed_records_total",
            "WAL records replayed at boot",
            labels=("datasource",),
        ).labels(datasource=ds).inc(records)
    if rows:
        reg.counter(
            "sdol_wal_replayed_rows_total",
            "rows re-applied from the WAL at boot",
            labels=("datasource",),
        ).labels(datasource=ds).inc(rows)


def record_snapshot_flush(datasource: str, segments: int) -> None:
    """Publish one persistent-snapshot commit (atomic rename landed)."""
    reg = get_registry()
    ds = bounded_label("ingest_datasource", datasource)
    reg.counter(
        "sdol_snapshot_flushes_total",
        "persistent segment snapshot commits, by datasource",
        labels=("datasource",),
    ).labels(datasource=ds).inc()
    if segments:
        reg.counter(
            "sdol_snapshot_segments_total",
            "segments written by snapshot flushes",
            labels=("datasource",),
        ).labels(datasource=ds).inc(segments)


def record_snapshot_sweep(flushed: int) -> None:
    """Publish one background snapshot-flush sweep pass (the timer
    fired and scanned for dirty datasources).  Per-datasource flush
    volume is already on `sdol_snapshot_flushes_total`; this counts the
    sweep itself plus how many tables it found dirty."""
    reg = get_registry()
    reg.counter(
        "sdol_snapshot_sweeps_total",
        "background snapshot-flush sweep passes",
    ).inc()
    if flushed:
        reg.counter(
            "sdol_snapshot_sweep_flushes_total",
            "datasources flushed by the background snapshot sweep",
        ).inc(flushed)


def record_rollup(datasource: str, rows_in: int, rows_out: int) -> None:
    """Publish one ingest-time rollup: input vs surviving rows.  The
    ratio is the fleet-level answer to "what does rollup actually buy"
    — Druid's own rollup-ratio metric."""
    reg = get_registry()
    ds = bounded_label("ingest_datasource", datasource)
    if rows_in:
        reg.counter(
            "sdol_rollup_input_rows_total",
            "append rows entering ingest-time rollup",
            labels=("datasource",),
        ).labels(datasource=ds).inc(rows_in)
    if rows_out:
        reg.counter(
            "sdol_rollup_output_rows_total",
            "pre-aggregated rows surviving ingest-time rollup",
            labels=("datasource",),
        ).labels(datasource=ds).inc(rows_out)


def record_storage_load(nbytes: int) -> None:
    """Publish one disk-tier column open (np.load mmap of a persisted
    column file): the DISK rung of the residency ladder, next to the
    h2d byte counters the device tiers publish."""
    reg = get_registry()
    reg.counter(
        "sdol_storage_column_opens_total",
        "lazy opens of persisted column files (disk residency tier)",
    ).inc()
    if nbytes:
        reg.counter(
            "sdol_storage_column_bytes_total",
            "logical bytes of persisted columns opened from disk "
            "(mmap-backed; pages fault in lazily on first touch)",
        ).inc(nbytes)


def record_cluster_rpc(
    node: str, outcome: str, ms: float = 0.0, query_id: str = "",
    hedged: bool = False, failover: bool = False,
) -> None:
    """One broker attempt at a historical (cluster/): a count per node and
    outcome, the attempt's latency, and the failover and hedge counters.
    Node ids pass the label cardinality guard."""
    reg = get_registry()
    labels = {
        "node": bounded_label("cluster_node", node or "unknown"),
        "outcome": bounded_label("cluster_outcome", outcome or "unknown"),
    }
    reg.counter(
        "sdol_cluster_scatter_total",
        "broker scatter RPCs to historicals, by node and outcome",
        labels=("node", "outcome"),
    ).labels(**labels).inc()
    if ms > 0:
        reg.histogram(
            "sdol_cluster_rpc_ms",
            "broker->historical RPC latency (one replica attempt)",
            buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                     1000.0, 5000.0),
        ).observe(float(ms), exemplar=query_id or None)
    if failover:
        reg.counter(
            "sdol_cluster_failover_total",
            "scatter attempts that failed over to another replica",
            labels=("node",),
        ).labels(node=labels["node"]).inc()
    if hedged:
        reg.counter(
            "sdol_cluster_hedge_total",
            "scatter fetches hedged to a second replica past the "
            "hedge threshold",
            labels=("node",),
        ).labels(node=labels["node"]).inc()


def record_cluster_health(
    live: int, total: int, epoch: int, deficit: int, lost: int = 0,
) -> None:
    """The broker's cluster gauges: live historicals, the membership, the
    assignment epoch, segments below their replication and (`lost`)
    segments with no live replica, which answer as stamped partials."""
    reg = get_registry()
    reg.gauge(
        "sdol_cluster_historicals_live",
        "historicals whose breaker admits traffic",
    ).set(int(live))
    reg.gauge(
        "sdol_cluster_historicals_total",
        "historicals in the broker's membership",
    ).set(int(total))
    reg.gauge(
        "sdol_cluster_assignment_epoch",
        "monotonic assignment epoch (bumps on membership change)",
    ).set(int(epoch))
    reg.gauge(
        "sdol_cluster_replication_deficit",
        "segments currently below their replication factor",
    ).set(int(deficit))
    reg.gauge(
        "sdol_cluster_segments_lost",
        "segments with zero live replicas (served as stamped partials)",
    ).set(int(lost))
