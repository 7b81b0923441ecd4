"""Append-only delta segments: streamed rows, queryable at once.

Rows arrive through `TPUOlapContext.append_rows` (or the server's
`POST /druid/v2/ingest/{datasource}` route), are dictionary-encoded against
the datasource's global dictionaries, and publish as `DeltaSegment`s in a
new immutable DataSource through `MetadataCache.put`, so the next
`catalog.get()` (the next query) sees them: no row is published and
invisible.

Every aggregate is a mergeable partial state and every executor (the
engine's loop and arena, the adaptive and sparse tiers, the host fallback)
already merges per-segment partials, so a delta segment is one more small
segment in scope, on the card like any other.

Appended values are domain values (strings for string dimensions, the
numbers for numeric ones), never codes: codes are rank-assigned and shift
when a dictionary extends.

A novel dimension value extends the dictionary (`extend_dict`: a sorted
superset whose old -> new LUT is strictly monotone), and every historical
and earlier delta segment remaps its codes through the LUT
(`remap_segment_codes`, an O(rows) gather per affected dimension).  The
remapped segments carry fresh uids, and the retired uids go to
`on_segments_dropped` (the context evicts their device columns, pinned
host copies and graphs); the dictionary's change also changes the
datasource's dictionary signature, so cached lowerings and results keyed
on it miss.  Appends of known values touch nothing historical.

Concurrency: one RLock per datasource buffer, under which every delta
mutation runs; queries take no lock: they hold an immutable DataSource
from the catalog, so an append mid-query is not visible to it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..catalog.cache import MetadataCache
from ..catalog.segment import (
    NULL_ID,
    ROW_PAD,
    DataSource,
    DimensionDict,
    Segment,
    as_delta,
    build_datasource,
    extend_dict,
    remap_segment_codes,
)
from ..obs import (
    SPAN_INGEST,
    SPAN_INGEST_ENCODE,
    SPAN_ROLLUP,
    record_ingest,
    record_rollup,
    span,
)
from ..resilience import checkpoint, device_fault
from ..utils.granularity import granularity_period_ms
from ..utils.log import get_logger

log = get_logger("ingest.delta")


class _DeltaBuffer:
    """Per-datasource append serialization point: the RLock every delta
    mutation (append, dictionary extension, compaction swap) runs under,
    and the monotonic delta sequence counter.  Fields mutate only under
    `_lock`."""

    def __init__(self):
        self._lock = threading.RLock()
        self._next_seq = 0

    def next_seq(self) -> int:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            return seq


class IngestManager:
    """Owns streamed ingest for one context: per-datasource delta buffers,
    the append path, and the locking surface compaction shares.

    Mutation is serialized per datasource; publication goes through
    `MetadataCache.put` alone, so every visible change carries a bumped
    datasource version."""

    def __init__(self, catalog: MetadataCache, config=None):
        self.catalog = catalog
        self.config = config
        self._lock = threading.Lock()
        self._buffers: Dict[str, _DeltaBuffer] = {}
        # eviction hook: called with the uids of segments that left the
        # published set (the engine drops their device residency)
        self.on_segments_dropped = None
        # the durable tier (storage.DurableStorage): when attached, every
        # append journals its normalized batch to the datasource's WAL,
        # fsync'd, before the publish, so an acknowledgement implies
        # durability.  None: nothing survives a restart.
        self.storage = None

    def _seal_rows(self) -> int:
        return int(getattr(self.config, "delta_seal_rows", 1 << 16) or 1 << 16)

    def buffer(self, name: str) -> _DeltaBuffer:
        with self._lock:
            buf = self._buffers.get(name)
            if buf is None:
                buf = self._buffers[name] = _DeltaBuffer()
            return buf

    def delta_rows(self, name: str) -> int:
        ds = self.catalog.get(name)
        return ds.delta_rows if ds is not None else 0

    def _dropped(self, uids) -> None:
        """Hands the retired uids to `on_segments_dropped`.  A failure of
        the hook is logged and the publish stands (the retired segments are
        out of every scope; what is left is memory held until LRU
        pressure), except a device fault (`resilience.device_fault`: a
        sticky CUDA error or a KernelError), which propagates: the card is
        lost, and no later query may find out by itself."""
        hook = self.on_segments_dropped
        if hook is not None and uids:
            try:
                hook(frozenset(uids))
            except Exception as err:
                if device_fault(err):
                    raise
                log.warning("segment-drop hook failed", exc_info=True)

    # -- the append path -----------------------------------------------------

    def append_rows(self, name: str, rows) -> dict:
        """Append streamed rows to a registered datasource.

        `rows` is a list of row dicts (the wire shape) or a mapping of
        row-aligned columns.  Missing dimensions fill with null and
        missing metrics with 0; unknown columns are rejected — streamed
        rows cannot widen a schema.  Returns an ack carrying the appended
        row count and the new datasource version."""
        buf = self.buffer(name)
        with buf._lock, span(SPAN_INGEST, datasource=name):
            ds = self.catalog.get(name)
            if ds is None:
                raise KeyError(f"unknown datasource {name!r}")
            cols, n = _normalize_rows(ds, rows)
            if n == 0:
                return {
                    "appended": 0,
                    "datasourceVersion": ds.version,
                    "totalRows": ds.num_rows,
                }
            # ingest-time rollup BEFORE the journal point: the WAL stores
            # (and boot replays) the already-rolled batch, so the rollup
            # shrinks durable volume too, not just the delta scan
            cols, n_stored = rollup_batch(ds, cols, n)
            # journal before publish: once this returns the batch is
            # fsync-durable, so a crash at any later point replays it, and
            # a crash before it never acknowledged it
            self._journal(name, cols, n_stored)
            with span(SPAN_INGEST_ENCODE, rows=n_stored):
                ds2, dropped = self._append_encoded(ds, cols, buf)
            published = self.catalog.put(ds2)
            self._dropped(dropped)
            record_ingest(name, n, "ok")
            return {
                "appended": n,
                "datasourceVersion": published.version,
                "totalRows": published.num_rows,
            }

    def _journal(self, name: str, cols: Dict[str, np.ndarray],
                 n: int) -> Optional[int]:
        """WAL journal point of the append path (no-op without an
        attached durable-storage tier).  Caller holds the buffer lock."""
        storage = self.storage
        if storage is None:
            return None
        return storage.journal_append(name, cols, n)

    def replay_batch(
        self, name: str, cols: Dict[str, np.ndarray]
    ) -> DataSource:
        """Boot-time WAL replay of one journaled batch: the exact
        `_append_encoded` path appends use — dictionary extension,
        remap, encode, seq stamping — WITHOUT re-journaling (the record
        is already durable) and without an ack.  Replayed state is
        therefore code-identical to what the pre-crash process
        published."""
        buf = self.buffer(name)
        with buf._lock:
            ds = self.catalog.get(name)
            if ds is None:
                raise KeyError(f"unknown datasource {name!r}")
            ds2, dropped = self._append_encoded(ds, cols, buf)
            published = self.catalog.put(ds2)
            self._dropped(dropped)
            return published

    def _append_encoded(
        self, ds: DataSource, cols: Dict[str, np.ndarray], buf: _DeltaBuffer
    ) -> Tuple[DataSource, frozenset]:
        """Encode one normalized batch into DeltaSegments spliced onto a
        new snapshot.  Returns (snapshot, uids of replaced segments) —
        the caller publishes and evicts.  Caller holds the buffer lock."""
        dim_names = [c.name for c in ds.columns if c.is_dimension]
        met_names = [c.name for c in ds.columns if c.is_metric]

        # dictionary extension first: novel values shift the code space,
        # and EVERY already-encoded segment (historical + delta) must
        # remap before the new rows encode against the extended dicts
        dicts = dict(ds.dicts)
        luts: Dict[str, np.ndarray] = {}
        for d in dim_names:
            new_dict, lut = extend_dict(
                dicts[d], _domain_values(cols[d], dicts[d])
            )
            if lut is not None:
                dicts[d] = new_dict
                luts[d] = lut
        segments: Tuple[Segment, ...] = ds.segments
        dropped: frozenset = frozenset()
        if luts:
            cards = {d: dicts[d].cardinality for d in luts}
            log.info(
                "append to %s extends dictionaries %s; remapping %d "
                "segments", ds.name, sorted(luts), len(segments),
            )
            remapped: List[Segment] = []
            for seg in segments:
                # O(segments) gather passes: honor an armed deadline
                # between segments, same as the query-side loops
                checkpoint("ingest.remap_segment")
                remapped.append(remap_segment_codes(seg, luts, cards))
            dropped = frozenset(s.uid for s in segments)
            segments = tuple(remapped)

        # encode VALUES -> codes explicitly (the int-with-dict fast path
        # in build_datasource means "already codes", which appended domain
        # values are not), then build padded delta segments through the
        # existing encoder's pre-encoded path
        enc = dict(cols)
        for d in dim_names:
            enc[d] = _encode_values(cols[d], dicts[d])
        part = build_datasource(
            ds.name,
            enc,
            dimension_cols=dim_names,
            metric_cols=met_names,
            time_col=ds.time_column,
            rows_per_segment=max(self._seal_rows(), ROW_PAD),
            dicts=dicts,
        )
        fresh = []
        for s in part.segments:
            seq = buf.next_seq()
            fresh.append(
                as_delta(
                    dataclasses.replace(
                        s, segment_id=f"{ds.name}_delta_{seq:06d}"
                    ),
                    seq=seq,
                )
            )
        return (
            dataclasses.replace(
                ds, dicts=dicts, segments=segments + tuple(fresh)
            ),
            dropped,
        )


def rollup_batch(
    ds: DataSource, cols: Dict[str, np.ndarray], n: int
) -> Tuple[Dict[str, np.ndarray], int]:
    """Pre-aggregate one normalized append batch under the datasource's
    declared rollup granularity.

    Time truncates to its granularity bucket; rows group by (every
    dimension, bucket); metrics SUM — the Druid ingest-spec `rollup`
    contract.  Runs BEFORE the WAL journal point, so durable volume and
    query-time delta scans both shrink.  Identity when no granularity is
    declared.  Deterministic (sorted group order), so a replayed WAL
    batch — journaled post-rollup — re-encodes byte-identically."""
    gran = getattr(ds, "rollup_granularity", None)
    if not gran or n == 0:
        return cols, n
    period = granularity_period_ms(gran)
    if period is None or ds.time_column is None:
        # calendar granularities and timeless tables are rejected at
        # registration; reaching here means the snapshot predates the
        # check — fail safe by storing exact rows
        return cols, n
    import pandas as pd

    with span(SPAN_ROLLUP, datasource=ds.name, rows_in=n):
        bucket = (
            np.asarray(cols[ds.time_column], dtype=np.int64) // period
        ) * period
        dim_names = [c.name for c in ds.columns if c.is_dimension]
        met_names = [c.name for c in ds.columns if c.is_metric]
        frame = {d: cols[d] for d in dim_names}
        frame["__bucket__"] = bucket
        mets = pd.DataFrame({m: cols[m] for m in met_names})
        keyed = pd.concat([pd.DataFrame(frame), mets], axis=1)
        grouped = keyed.groupby(
            dim_names + ["__bucket__"], dropna=False, sort=True,
            as_index=False,
        )[met_names].sum()
        out: Dict[str, np.ndarray] = {}
        for d in dim_names:
            a = grouped[d].to_numpy()
            if a.dtype.kind in "Of":
                src = np.asarray(cols[d])
                if src.dtype.kind == "O":
                    # groupby surfaces nulls as NaN; the encode path
                    # expects object columns with None
                    a = np.asarray(
                        [None if pd.isna(v) else v for v in a],
                        dtype=object,
                    )
                elif src.dtype.kind in "iu" and a.dtype.kind == "f":
                    a = a.astype(src.dtype)
            out[d] = a
        out[ds.time_column] = grouped["__bucket__"].to_numpy(np.int64)
        for m in met_names:
            a = grouped[m].to_numpy()
            src = np.asarray(cols[m])
            if a.dtype != src.dtype:
                a = a.astype(src.dtype)
            out[m] = a
        n_out = len(grouped)
        record_rollup(ds.name, n, n_out)
    return out, n_out


def _domain_values(col: np.ndarray, d: DimensionDict) -> list:
    """The distinct candidate domain values of an appended column (for
    novel-value detection): raw values for string dictionaries, int64
    values (negatives = null, excluded) for numeric ones."""
    if d.numeric_values is not None or (
        not d.values and np.asarray(col).dtype.kind in "iuf"
    ):
        a = _as_int64(col)
        return [int(v) for v in np.unique(a[a >= 0])]
    import pandas as pd

    arr = np.asarray(col, dtype=object)
    return [v for v in pd.unique(arr) if not pd.isna(v)]


def _encode_values(col: np.ndarray, d: DimensionDict) -> np.ndarray:
    """Appended domain values -> global int32 codes."""
    if d.numeric_values is not None or (
        not d.values and np.asarray(col).dtype.kind in "iuf"
    ):
        return d.encode_numeric(_as_int64(col))
    return d.encode(list(np.asarray(col, dtype=object)))


def _as_int64(col) -> np.ndarray:
    """Object/float/int column -> int64 with nulls as NULL_ID."""
    a = np.asarray(col)
    if a.dtype.kind == "O":
        import pandas as pd

        mask = pd.isna(a)
        out = np.full(len(a), NULL_ID, dtype=np.int64)
        if (~mask).any():
            out[~mask] = np.asarray(
                [int(v) for v in a[~mask]], dtype=np.int64
            )
        return out
    if a.dtype.kind == "f":
        out = np.where(np.isnan(a), NULL_ID, a).astype(np.int64)
        return out
    return a.astype(np.int64)


def _normalize_rows(
    ds: DataSource, rows
) -> Tuple[Dict[str, np.ndarray], int]:
    """Wire rows -> row-aligned columns covering the datasource schema.

    Accepts a list of row dicts or a mapping of columns.  Unknown column
    names raise (schema is fixed at registration); missing dimensions
    fill with null, missing metrics with 0, and a missing time column is
    an error when the datasource has one (interval pruning would
    misplace the rows)."""
    known = {c.name for c in ds.columns}
    if isinstance(rows, Mapping):
        cols_in = {k: np.asarray(v) for k, v in rows.items()}
        lens = {len(v) for v in cols_in.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged append columns: lengths {sorted(lens)}")
        n = lens.pop() if lens else 0
    elif isinstance(rows, Sequence) and not isinstance(rows, (str, bytes)):
        keys: List[str] = []
        for r in rows:
            if not isinstance(r, Mapping):
                raise ValueError("append rows must be objects")
            for k in r:
                if k not in keys:
                    keys.append(k)
        n = len(rows)
        cols_in = {
            k: np.asarray([r.get(k) for r in rows], dtype=object)
            for k in keys
        }
    else:
        raise ValueError(
            f"unsupported append payload type {type(rows).__name__}"
        )
    unknown = sorted(set(cols_in) - known)
    if unknown:
        raise ValueError(
            f"append names unknown columns {unknown}; datasource "
            f"{ds.name!r} schema is fixed at registration"
        )
    if n == 0:
        return {}, 0  # empty append: an ack, not a schema error
    out: Dict[str, np.ndarray] = {}
    for c in ds.columns:
        v = cols_in.get(c.name)
        if c.kind == "time":
            if v is None:
                raise ValueError(
                    f"append is missing time column {c.name!r}"
                )
            out[c.name] = _coerce_time(v)
        elif c.is_metric:
            if v is None:
                v = np.zeros(n)
            a = np.asarray(v)
            if a.dtype.kind == "O":
                a = a.astype(np.float64)
            # match the REGISTERED metric dtype: a "long" metric appended
            # as floats must land int32 like its historical siblings, or
            # delta and historical partials would accumulate in different
            # arithmetic
            if c.dtype == "long" and a.dtype.kind == "f":
                a = np.where(np.isnan(a), 0, a).astype(np.int64)
            elif c.dtype == "double" and a.dtype.kind in "iu":
                a = a.astype(np.float64)
            out[c.name] = a
        else:  # dimension
            if v is None:
                d = ds.dicts.get(c.name)
                if d is not None and d.numeric_values is not None:
                    v = np.full(n, NULL_ID, dtype=np.int64)
                else:
                    v = np.full(n, None, dtype=object)
            out[c.name] = np.asarray(v)
    return out, n


def _coerce_time(v) -> np.ndarray:
    """Time values -> int64 epoch millis (ISO strings, datetimes, or raw
    millis — the shapes Druid ingest specs accept).  Null/unparseable
    values RAISE: a silently-NaT row would carry INT64_MIN millis and be
    permanently misplaced by interval pruning."""
    a = np.asarray(v)
    if a.dtype.kind == "O":
        import pandas as pd

        if pd.isna(a).any():
            raise ValueError("append has null values in the time column")
    if a.dtype.kind in ("i", "u"):
        return a.astype(np.int64)
    if a.dtype.kind == "f":
        if np.isnan(a).any():
            raise ValueError("append has null values in the time column")
        return a.astype(np.int64)
    if a.dtype.kind != "M":
        try:
            a = np.asarray(a, dtype="datetime64[ms]")
        except Exception as e:
            raise ValueError(f"unparseable time values in append: {e}")
    out = a.astype("datetime64[ms]").astype(np.int64)
    if np.isnat(a.astype("datetime64[ms]")).any():
        raise ValueError("append has null/NaT values in the time column")
    return out
