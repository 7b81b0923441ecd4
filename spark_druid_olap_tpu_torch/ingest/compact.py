"""Versioned compaction: delta segments roll into historical segments.

Delta segments are small (an append must be cheap and visible at once),
but a query over N small deltas pays N segments of dispatch and padding.
The compactor rolls a datasource's `DeltaSegment`s into tiled, padded
historical segments (the `rows_per_segment`-row, zone-mapped segments bulk
ingest makes) and publishes the swap through `MetadataCache.put`, which
bumps the datasource's version: the result cache keys on it, and the
arena's programs key on segment uids, so a compaction invalidates what it
must while the row set, and every answer, stays the same.

Compaction runs under the per-datasource lock appends take, so an append
and a compaction never interleave their read-modify-write of the segment
list; queries never block (they hold immutable snapshots).  The retired
uids go to the engine's eviction hook, so their device columns, pinned
host copies and graphs go at once.

The background worker is a daemon thread with a cooperative stop event;
every sweep checkpoints (`resilience.checkpoint`) between segments.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..catalog.segment import (
    DataSource,
    DeltaSegment,
    Segment,
    build_datasource,
)
from ..obs import SPAN_COMPACT, record_compaction, span
from ..resilience import checkpoint, device_fault
from ..utils.log import get_logger
from .delta import IngestManager

log = get_logger("ingest.compact")


class Compactor:
    """Rolls delta segments into historical segments, with an optional
    background sweep thread."""

    def __init__(
        self,
        ingest: IngestManager,
        rows_per_segment: int = 1 << 19,
        min_delta_rows: int = 0,
        interval_s: float = 5.0,
        min_delta_segments: int = 64,
        sys_retention_s: float = 0.0,
    ):
        self.ingest = ingest
        self.rows_per_segment = int(rows_per_segment)
        self.min_delta_rows = int(min_delta_rows)
        # a trickle of tiny appends accretes SEGMENTS (each padded to
        # ROW_PAD) long before it accretes rows — the sweep must gate on
        # both, or a 1-row/s feed would pile up padded deltas forever
        # while staying under the row threshold
        self.min_delta_segments = max(1, int(min_delta_segments))
        self.interval_s = float(interval_s)
        # `__sys` telemetry retention (config.sys_retention_s): the
        # sweep drops whole aged rollup segments; 0 keeps everything
        self.sys_retention_s = float(sys_retention_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.compactions_total = 0
        # the durable tier (storage.DurableStorage): when attached, a
        # compaction flushes the folded snapshot (atomic rename), deletes
        # retired column files strictly after the rename commits, and
        # truncates the WAL through the folded watermark, all under the
        # per-datasource ingest lock
        self.storage = None

    # -- one datasource ------------------------------------------------------

    def compact(self, name: str) -> dict:
        """Compact `name`'s delta segments now.  Returns a summary dict
        ({"compacted_rows": 0, ...} when there was nothing to do)."""
        buf = self.ingest.buffer(name)
        with buf._lock, span(SPAN_COMPACT, datasource=name):
            ds = self.ingest.catalog.get(name)
            if ds is None:
                raise KeyError(f"unknown datasource {name!r}")
            deltas = ds.delta_segments()
            if not deltas:
                return {
                    "datasource": name,
                    "compacted_rows": 0,
                    "delta_segments": 0,
                    "datasourceVersion": ds.version,
                }
            rolled, absorbed = self._roll(ds, deltas)
            keep = list(ds.historical_segments())
            if absorbed:  # _roll only ever absorbs the undersized tail
                keep = keep[: -len(absorbed)]
            base = len(keep)
            segments: List[Segment] = keep + [
                dataclasses.replace(
                    s, segment_id=f"{name}_{base + i:06d}"
                )
                for i, s in enumerate(rolled)
            ]
            published = self.ingest.catalog.put(
                dataclasses.replace(ds, segments=tuple(segments))
            )
            dropped = frozenset(
                s.uid for s in list(deltas) + list(absorbed)
            )
            self.ingest._dropped(dropped)
            if self.storage is not None:
                # still under the buffer lock: no append can extend the
                # WAL between "every delta is folded into `published`"
                # and the watermark the flush truncates through
                self.storage.flush_locked(name, published)
        with self._lock:
            self.compactions_total += 1
        n_rows = sum(s.num_rows for s in deltas)
        record_compaction(name, n_rows, len(deltas))
        log.info(
            "compacted %s: %d delta segments (%d rows) -> %d historical",
            name, len(deltas), n_rows, len(rolled),
        )
        return {
            "datasource": name,
            "compacted_rows": n_rows,
            "delta_segments": len(deltas),
            "historical_segments_out": len(rolled),
            "datasourceVersion": published.version,
        }

    def _roll(
        self, ds: DataSource, deltas: Tuple[DeltaSegment, ...]
    ) -> Tuple[List[Segment], List[Segment]]:
        """Concatenate delta rows (plus an undersized historical tail, so
        repeated append/compact cycles converge to full tiles instead of
        accreting slivers) and re-segment them at `rows_per_segment`.
        Codes are already global — this is pure array splicing, no
        re-encode.  Returns (new historical segments, absorbed tail)."""
        absorbed: List[Segment] = []
        hist = list(ds.historical_segments())
        if hist and hist[-1].num_rows < self.rows_per_segment // 2:
            absorbed.append(hist[-1])
        parts: List[Segment] = absorbed + list(deltas)
        dim_names = [c.name for c in ds.columns if c.is_dimension]
        met_names = [c.name for c in ds.columns if c.is_metric]
        cols = {}
        for name in dim_names + met_names:
            pieces = []
            for s in parts:
                # O(delta rows) splice: keep the deadline honest while a
                # large backlog drains
                checkpoint("compact.splice_segment")
                pieces.append(np.asarray(s.column(name))[s.valid])
            cols[name] = np.concatenate(pieces)
        if ds.time_column is not None:
            pieces = []
            for s in parts:
                checkpoint("compact.splice_segment")
                pieces.append(np.asarray(s.time)[s.valid])
            cols[ds.time_column] = np.concatenate(pieces)
        part = build_datasource(
            ds.name,
            cols,
            dimension_cols=dim_names,
            metric_cols=met_names,
            time_col=ds.time_column,
            rows_per_segment=self.rows_per_segment,
            dicts=dict(ds.dicts),
        )
        return list(part.segments), absorbed

    # -- age-based retention (`__sys` telemetry ring) ------------------------

    def retire_aged(
        self, name: str, retention_s: float,
        now_ms: Optional[int] = None,
    ) -> dict:
        """Drop every HISTORICAL segment of `name` whose newest row is
        older than `retention_s` seconds.  Whole segments only — the
        second-granularity `__sys` rollup makes segments time-local, so
        age-out never needs a partial rewrite; delta segments are left
        for normal compaction to fold first (dropping an unfolded delta
        would resurrect its rows from the WAL on recovery).  Runs under
        the same per-datasource ingest lock appends and compactions
        take, and flushes the shrunk snapshot through the storage tier's
        rename-then-GC commit protocol when one is attached."""
        if retention_s <= 0:
            return {"datasource": name, "dropped_segments": 0}
        if now_ms is None:
            now_ms = int(time.time() * 1e3)
        cutoff_ms = now_ms - retention_s * 1e3
        buf = self.ingest.buffer(name)
        with buf._lock:
            ds = self.ingest.catalog.get(name)
            if ds is None or ds.time_column is None:
                return {"datasource": name, "dropped_segments": 0}
            keep: List[Segment] = []
            drop = []
            for s in ds.segments:
                checkpoint("compact.sweep_datasource")
                t = s.time
                if t is None or isinstance(s, DeltaSegment):
                    keep.append(s)
                    continue
                tv = np.asarray(t)[s.valid]
                if tv.size and float(tv.max()) < cutoff_ms:
                    drop.append(s)
                else:
                    keep.append(s)
            if not drop:
                return {"datasource": name, "dropped_segments": 0}
            published = self.ingest.catalog.put(
                dataclasses.replace(ds, segments=tuple(keep))
            )
            self.ingest._dropped(frozenset(s.uid for s in drop))
            if self.storage is not None:
                self.storage.flush_locked(name, published)
        n_rows = sum(s.num_rows for s in drop)
        log.info(
            "retired %d aged segment(s) (%d rows) from %s "
            "(retention %.0fs)", len(drop), n_rows, name, retention_s,
        )
        return {
            "datasource": name,
            "dropped_segments": len(drop),
            "dropped_rows": n_rows,
            "datasourceVersion": published.version,
        }

    def _retire_sys(self) -> dict:
        from ..obs.telemetry import SYS_TABLE

        if self.ingest.catalog.get(SYS_TABLE) is None:
            return {"datasource": SYS_TABLE, "dropped_segments": 0}
        return self.retire_aged(SYS_TABLE, self.sys_retention_s)

    # -- background sweep ----------------------------------------------------

    def run_pending(self) -> List[dict]:
        """One sweep: compact every datasource whose delta backlog meets
        `min_delta_rows` OR whose delta SEGMENT count meets
        `min_delta_segments` (tiny-append trickles accrete padded
        segments, not rows).  Safe to call concurrently with appends."""
        out = []
        for name in self.ingest.catalog.tables():
            checkpoint("compact.sweep_datasource")
            ds = self.ingest.catalog.get(name)
            if ds is None:
                continue
            pending = ds.delta_rows
            n_segs = len(ds.delta_segments())
            if pending and (
                pending >= self.min_delta_rows
                or n_segs >= self.min_delta_segments
            ):
                try:
                    out.append(self.compact(name))
                except Exception as err:
                    # one table must not stop the sweep; a device fault
                    # (from the eviction hook) is the card's, not the table's
                    if device_fault(err):
                        raise
                    log.warning(
                        "background compaction of %s failed", name,
                        exc_info=True,
                    )
        if self.sys_retention_s > 0:
            try:
                res = self._retire_sys()
                if res.get("dropped_segments"):
                    out.append(res)
            except Exception as err:  # retention must not stop the sweep
                if device_fault(err):
                    raise
                log.warning("__sys retention sweep failed", exc_info=True)
        return out

    def start(self) -> "Compactor":
        """Start the background sweep thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="sdol-compactor", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_pending()
            except Exception as err:
                if device_fault(err):
                    # the card is lost: stop sweeping, the queries report it
                    log.error("compaction sweep stopped by a device fault", exc_info=True)
                    return
                log.warning("compaction sweep failed", exc_info=True)
