"""Self-hosted telemetry: the `__sys` datasource.

Druid ships a metrics surface operators query in SQL instead of standing
up an external time-series store.  This is its analog: a sampler flushes
the process metrics registry (`obs.registry.get_registry().to_dict()`)
into an ordinary datasource named `__sys` through the ingest and WAL tier
user appends take (journaled before publish, rolled up at `second`
granularity, flushed and compacted by the usual sweeps), so QPS, latency
percentiles, breaker flips and ingest volume are one `SELECT ... FROM
__sys` away, and such a query runs on the card like any other.

Schema (long and narrow, one row per series per tick):

    ts      int64  sample wall-clock, ms      (time column)
    metric  str    family name; histograms flatten into suffixed
                   `_count/_sum/_p50/_p95/_p99` rows
    labels  str    comma-joined label values of the child series
                   ("" for a bare family)
    kind    str    counter | gauge | histogram
    value   float  the sampled reading
    delta   float  reading minus the previous tick's reading of the same
                   (metric, labels) series: QPS is `sum(delta) / interval`
                   over the query counter

Ticks append through `ctx.ingest.append_rows` directly (not the server's
ingest route), so telemetry opens no query trace and never queues behind
the server's admission pool.  The sampler thread is a daemon, and a tick
that fails logs, counts and leaves the next tick to proceed (a device
fault excepted, which propagates).

Cardinality guard: one tick appends at most `max_series` rows (sorted
family order, deterministic truncation), and the drop count shows in
`status()` and in `__sys` itself through the sampler's own
`sdol_sys_sampler_*` families.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..resilience import device_fault
from .registry import get_registry
from ..utils.log import get_logger

log = get_logger("obs.telemetry")

__all__ = ["SYS_TABLE", "SysSampler"]

SYS_TABLE = "__sys"

# histogram snapshot entries flatten into these suffixed series; the
# percentile rows sample as gauges (a delta of p99 is meaningless)
_HIST_FIELDS: Tuple[Tuple[str, str, str], ...] = (
    ("count", "_count", "counter"),
    ("sum_ms", "_sum", "counter"),
    ("p50", "_p50", "gauge"),
    ("p95", "_p95", "gauge"),
    ("p99", "_p99", "gauge"),
)


def _flatten(
    snapshot: Dict[str, dict]
) -> List[Tuple[str, str, str, float]]:
    """Registry `to_dict()` -> [(metric, labels, kind, value)] in
    deterministic (family, labels) order."""
    out: List[Tuple[str, str, str, float]] = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        kind = str(fam.get("type", "gauge"))
        values = fam.get("values") or {}
        for labels in sorted(values):
            v = values[labels]
            if isinstance(v, dict):
                for field, suffix, fkind in _HIST_FIELDS:
                    fv = v.get(field)
                    if fv is None:
                        continue
                    out.append(
                        (name + suffix, labels, fkind, float(fv))
                    )
            else:
                try:
                    out.append((name, labels, kind, float(v)))
                except (TypeError, ValueError):
                    continue
    return out


class SysSampler:
    """Background registry -> `__sys` flusher.  `start()` spawns the
    daemon tick loop; `sample_once()` is one synchronous tick (tests call
    it directly, with no thread and no sleep)."""

    def __init__(
        self,
        ctx,
        interval_s: float = 5.0,
        max_series: int = 512,
    ):
        self.ctx = ctx
        self.interval_s = max(0.1, float(interval_s))
        self.max_series = int(max_series)
        self._prev: Dict[Tuple[str, str], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.ticks = 0
        self.rows_appended = 0
        self.rows_dropped = 0
        self.errors = 0
        self.last_tick_ms = 0.0
        self.last_error = ""
        reg = get_registry()
        self._m_rows = reg.counter(
            "sdol_sys_sampler_rows_total",
            "rows appended to __sys by the telemetry sampler",
        )
        self._m_dropped = reg.counter(
            "sdol_sys_sampler_dropped_total",
            "series dropped by the __sys per-tick cardinality cap",
        )
        self._m_errors = reg.counter(
            "sdol_sys_sampler_errors_total",
            "failed __sys sampler ticks (fault-isolated, loop continues)",
        )

    # -- registration --------------------------------------------------------

    def _ensure_table(self, seed_cols: Dict[str, np.ndarray]) -> None:
        """First tick registers `__sys` (idempotent thereafter) with the
        seed batch itself — `register_table` needs rows, and this way
        the very first sample is queryable too.  Rollup at `second`
        granularity: a re-sampled second folds instead of duplicating,
        and the WAL journals the already-rolled batch."""
        if self.ctx.catalog.get(SYS_TABLE) is not None:
            return
        self.ctx.register_table(
            SYS_TABLE,
            seed_cols,
            dimensions=["metric", "labels", "kind"],
            metrics=["value", "delta"],
            time_column="ts",
            rows_per_segment=1 << 16,
            rollup_granularity="second",
        )

    # -- sampling ------------------------------------------------------------

    def _tick_cols(self) -> Tuple[Dict[str, np.ndarray], int]:
        series = _flatten(get_registry().to_dict())
        dropped = 0
        if len(series) > self.max_series:
            dropped = len(series) - self.max_series
            series = series[: self.max_series]
        now_ms = int(time.time() * 1e3)
        metric: List[str] = []
        labels: List[str] = []
        kind: List[str] = []
        value: List[float] = []
        delta: List[float] = []
        for name, lab, k, v in series:
            key = (name, lab)
            prev = self._prev.get(key)
            metric.append(name)
            labels.append(lab)
            kind.append(k)
            value.append(v)
            delta.append(v - prev if prev is not None else 0.0)
            self._prev[key] = v
        cols = {
            "ts": np.full(len(metric), now_ms, dtype=np.int64),
            "metric": np.array(metric, dtype=object),
            "labels": np.array(labels, dtype=object),
            "kind": np.array(kind, dtype=object),
            "value": np.asarray(value, dtype=np.float64),
            "delta": np.asarray(delta, dtype=np.float64),
        }
        return cols, dropped

    def sample_once(self) -> int:
        """One synchronous tick: snapshot -> flatten -> append.  Returns
        the row count appended (0 on a fault-isolated failure)."""
        t0 = time.perf_counter()
        with self._lock:
            try:
                cols, dropped = self._tick_cols()
                n = int(len(cols["ts"]))
                if n == 0:
                    return 0
                fresh = self.ctx.catalog.get(SYS_TABLE) is None
                self._ensure_table(cols)
                if not fresh:
                    # separate admission: straight into the ingest tier,
                    # no query trace, no server admission queue (the
                    # first tick's batch already seeded registration)
                    self.ctx.ingest.append_rows(SYS_TABLE, cols)
                self.ticks += 1
                self.rows_appended += n
                self.rows_dropped += dropped
                self._m_rows.inc(n)
                if dropped:
                    self._m_dropped.inc(dropped)
                self.last_tick_ms = (time.perf_counter() - t0) * 1e3
                return n
            except Exception as e:  # telemetry never takes down the
                # process it observes, but a device fault (from the
                # eviction hook of a dictionary-extending tick) is the
                # card's and propagates
                if device_fault(e):
                    raise
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"
                self._m_errors.inc()
                log.warning("__sys sampler tick failed: %s", e)
                return 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SysSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.interval_s):
                self.sample_once()

        self._thread = threading.Thread(
            target=run, name="sdol-sys-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def status(self) -> Dict[str, Any]:
        return {
            "table": SYS_TABLE,
            "running": bool(self._thread and self._thread.is_alive()),
            "interval_s": self.interval_s,
            "max_series": self.max_series,
            "ticks": self.ticks,
            "rows_appended": self.rows_appended,
            "rows_dropped": self.rows_dropped,
            "errors": self.errors,
            "last_error": self.last_error,
            "last_tick_ms": round(self.last_tick_ms, 3),
            "tracked_series": len(self._prev),
        }
