"""Columnar segment format: the immutable, host-side unit the engine scans.

A `Segment` is a time-partitioned, columnar shard in the Druid mould:
dictionary-encoded dimension columns (narrow signed codes, see
`code_dtype`), float32/int32 metric columns and an int64 millisecond time
column, all host numpy arrays.  `exec.engine` moves the columns a query
reads to the device once and keeps them resident.

  * Strings never reach the device: dimensions are dictionary-encoded at
    ingest and only codes are transferred.
  * Segments are immutable by construction (frozen dataclasses holding
    arrays that are never written).
  * Rows are padded to a multiple of `ROW_PAD` with a validity mask, so
    every kernel sees whole 1024-row blocks.

`build_datasource` encodes raw host columns; `datasource_from_numpy`
rebuilds a datasource from an already-encoded plain dict of arrays (the
form another process or the reference package exports), so both scan
identical segments.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# Process-unique segment identity: device-residency and compiled-program
# caches key on this, so re-ingesting a same-name datasource (same segment
# ids, different arrays) can never hit a stale cache entry.
_SEGMENT_UIDS = itertools.count(1)

# Row-count padding granularity: every segment is a whole number of
# 1024-row blocks, the block the group-by kernels sweep.
ROW_PAD = 1024

NULL_ID = -1  # dictionary code for null dimension values


@dataclasses.dataclass(frozen=True)
class DimensionDict:
    """Dictionary for one dimension: sorted unique values <-> int32 ids.

    Sorted order is load-bearing: it makes dictionary codes order-preserving,
    so range/bound filters on strings can be pushed down as integer range
    filters on codes (the reference pushes Druid `bound` filters with
    lexicographic ordering; sorted dicts give us the same for free).

    Integer-typed dimensions (years, yearmonth codes, bucket ids, ...) keep
    their values as python ints sorted numerically, and their codes are the
    dense rank in the *actual* value domain — NOT the raw value.  This keeps
    the combined group-id domain tight (d_year spans 7 codes, not 1999), which
    is what lets the dense one-hot kernel cover the common OLAP case.  Filters
    translate numeric literals into code space (ops/filters.py); expressions
    see decoded values via `DecodedView`.
    """

    values: Tuple  # str (string dims, sorted) or int (numeric dims, sorted)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    @functools.cached_property
    def content_key(self) -> int:
        """Stable hash of the value domain.  Rank codes are data-dependent
        (code 0 = smallest actual value), so any compiled-program cache keyed
        on a datasource MUST include this — two same-cardinality dictionaries
        with different domains give the same codes different meanings."""
        return hash(self.values)

    @functools.cached_property
    def numeric_values(self) -> Optional[np.ndarray]:
        """int64 value array when this is a numeric dictionary, else None."""
        if self.values and all(
            isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            for v in self.values
        ):
            return np.asarray(self.values, dtype=np.int64)
        return None

    def code_of(self, value) -> Optional[int]:
        """Exact-match dictionary code for a literal (str or numeric), or
        None when the literal is not in the domain."""
        nv = self.numeric_values
        if nv is not None:
            try:
                x = float(value)
            except (TypeError, ValueError):
                return None
            if x != int(x):
                return None
            i = int(np.searchsorted(nv, int(x)))
            if i < len(nv) and int(nv[i]) == int(x):
                return i
            return None
        try:
            return self.values.index(value)
        except ValueError:
            return None

    def encode_numeric(self, arr: np.ndarray) -> np.ndarray:
        """Rank-encode an int column; negatives and out-of-domain -> NULL_ID."""
        nv = self.numeric_values
        a = np.asarray(arr).astype(np.int64)
        if nv is None or len(nv) == 0:
            # empty domain (all-null / zero-row column): everything is null
            return np.full(len(a), NULL_ID, dtype=np.int32)
        idx = np.clip(np.searchsorted(nv, a), 0, len(nv) - 1)
        ok = (nv[idx] == a) & (a >= 0)
        return np.where(ok, idx, NULL_ID).astype(np.int32)

    @property
    def _values_str(self) -> np.ndarray:
        # cached str-typed values array: encode() is called once per chunk
        # per dimension during streamed ingest, and rebuilding this per
        # call dominated large-SF ingest profiles
        cached = self.__dict__.get("_values_str_cache")
        if cached is None:
            cached = np.asarray(self.values, dtype=str)
            object.__setattr__(self, "_values_str_cache", cached)
        return cached

    def encode(self, col: Sequence[Optional[str]]) -> np.ndarray:
        import pandas as pd

        arr = np.asarray(col, dtype=object)
        # vectorized null scan (None or float NaN): the per-value Python
        # loop here cost ~500s of SF100 ingest (3M-row dimension tables)
        mask = ~pd.isna(arr)
        out = np.full(len(arr), NULL_ID, dtype=np.int32)
        if mask.any():
            vals = arr[mask].astype(str)
            idx = np.searchsorted(self._values_str, vals)
            idx = np.clip(idx, 0, max(len(self.values) - 1, 0))
            found = self._values_str[idx] == vals
            codes = np.where(found, idx, NULL_ID).astype(np.int32)
            out[mask] = codes
        return out

    def decode(self, ids: np.ndarray) -> np.ndarray:
        vals = np.asarray(self.values, dtype=object)
        out = np.empty(len(ids), dtype=object)
        ok = ids >= 0
        out[ok] = vals[ids[ok]]
        out[~ok] = None
        return out

    @staticmethod
    def build(col: Sequence[Optional[str]]) -> "DimensionDict":
        import pandas as pd

        arr = np.asarray(col, dtype=object)
        uniq = sorted(pd.unique(arr[~pd.isna(arr)]).tolist())
        return DimensionDict(values=tuple(uniq))


def _is_null(v) -> bool:
    """None OR float NaN — Arrow/pandas surface string nulls as NaN floats
    inside object columns; both must dictionary-encode as NULL."""
    return v is None or (isinstance(v, float) and v != v)


@dataclasses.dataclass(frozen=True)
class ColumnMeta:
    """Schema entry for one column of a datasource."""

    name: str
    kind: str  # "dimension" | "metric" | "time"
    dtype: str  # "string" | "long" | "double" | "timestamp"
    cardinality: Optional[int] = None  # dimensions only

    @property
    def is_dimension(self) -> bool:
        return self.kind == "dimension"

    @property
    def is_metric(self) -> bool:
        return self.kind == "metric"


def code_dtype(cardinality: int) -> np.dtype:
    """Smallest signed dtype holding codes [-1, cardinality).

    Dimension columns dominate scan bytes on wide GroupBys (SSB q4_1 reads
    ~14 GB at SF100, mostly int32 codes); storing codes at their natural
    width cuts the memory-bound scan roughly in half for typical
    cardinalities.  Device kernels cast to int32 on entry (sub-word
    arithmetic is not the goal — HBM/stream bytes are), and hashing is
    value-preserving across widths (utils/hashing.hash_column sign-extends
    through uint32), so sketches keep bit-parity."""
    if cardinality - 1 <= 127:  # stored codes span [-1, cardinality-1]
        return np.dtype(np.int8)
    if cardinality - 1 <= 32767:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def _pad_rows(a: np.ndarray, n_padded: int, fill) -> np.ndarray:
    if len(a) == n_padded:
        return a
    pad = np.full(n_padded - len(a), fill, dtype=a.dtype)
    return np.concatenate([a, pad])


@dataclasses.dataclass(frozen=True)
class Segment:
    """One immutable columnar shard, padded to ROW_PAD rows.

    Arrays are host numpy; `exec.engine` moves them to device (and caches
    residency).  `valid` marks real rows vs padding — kernels fold it into
    their filter mask so padding never contributes to an aggregate.
    """

    segment_id: str
    num_rows: int  # real (unpadded) rows
    dims: Mapping[str, np.ndarray]  # name -> int32[n_padded]
    metrics: Mapping[str, np.ndarray]  # name -> float32/int32[n_padded]
    time: Optional[np.ndarray]  # int64 millis[n_padded] or None
    valid: np.ndarray  # bool[n_padded]
    interval: Optional[Tuple[int, int]] = None  # [min_ms, max_ms] of time col
    time_name: Optional[str] = None  # source column name of the time column
    uid: int = 0  # process-unique identity (see _SEGMENT_UIDS)
    # zone maps (per-segment "stats"): column ->
    # (min, max) over REAL rows — dimension columns in CODE space (nulls
    # excluded), metrics in value space.  Lets the engine prune segments a
    # filter provably cannot match, the way the time interval already does.
    stats: Optional[Mapping[str, Tuple[float, float]]] = None

    @property
    def num_rows_padded(self) -> int:
        return len(self.valid)

    def column(self, name: str) -> np.ndarray:
        if name in self.dims:
            return self.dims[name]
        if name in self.metrics:
            return self.metrics[name]
        if self.time is not None and name in ("__time", self.time_name):
            return self.time
        raise KeyError(f"segment {self.segment_id} has no column {name!r}")


@dataclasses.dataclass(frozen=True)
class DataSource:
    """A named datasource: schema + dictionaries + a list of segments.

    The analog of a Druid datasource's metadata and segment list.

    """

    name: str
    columns: Tuple[ColumnMeta, ...]
    dicts: Mapping[str, DimensionDict]
    segments: Tuple[Segment, ...]
    time_column: Optional[str] = None

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.segments)

    def meta(self, name: str) -> ColumnMeta:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"datasource {self.name} has no column {name!r}")

    def cardinality(self, dim: str) -> int:
        return self.dicts[dim].cardinality

    def interval(self) -> Optional[Tuple[int, int]]:
        ivs = [s.interval for s in self.segments if s.interval is not None]
        if not ivs:
            return None
        return (min(i[0] for i in ivs), max(i[1] for i in ivs))


def compute_segment_stats(
    dims: Mapping[str, np.ndarray],
    metrics: Mapping[str, np.ndarray],
    valid: np.ndarray,
) -> Dict[str, Tuple[float, float]]:
    """Per-column (min, max) zone maps over real rows; dimension columns in
    code space with nulls (code < 0) excluded."""
    # padding is a suffix by construction (_pad_rows), so "real rows" is a
    # slice, not a boolean gather (which would copy every column once)
    n_real = int(valid.sum())
    sliced = bool(valid[:n_real].all())
    out: Dict[str, Tuple[float, float]] = {}
    for d, codes in dims.items():
        c = np.asarray(codes)
        c = c[:n_real] if sliced else c[valid]
        c = c[c >= 0]
        if len(c):
            out[d] = (float(c.min()), float(c.max()))
    for m, vals in metrics.items():
        v = np.asarray(vals)
        v = v[:n_real] if sliced else v[valid]
        if len(v):
            out[m] = (float(v.min()), float(v.max()))
    return out


def build_datasource(
    name: str,
    columns: Mapping[str, np.ndarray],
    dimension_cols: Sequence[str],
    metric_cols: Sequence[str],
    time_col: Optional[str] = None,
    rows_per_segment: int = 1 << 22,
    dicts: Optional[Mapping[str, DimensionDict]] = None,
) -> DataSource:
    """Build a DataSource from raw host columns.

    String dimension columns are dictionary-encoded; integer-typed dimension
    columns are treated as already-encoded codes (their dictionary is the
    stringified value domain).  Metric columns become float32 (or int32 when
    integral).  Rows are split into segments of `rows_per_segment` and padded.
    """
    n = None
    for cname, col in columns.items():
        if n is None:
            n = len(col)
        elif len(col) != n:
            raise ValueError(f"column {cname} length {len(col)} != {n}")
    if n is None:
        raise ValueError("no columns")

    dicts = dict(dicts) if dicts else {}
    encoded: Dict[str, np.ndarray] = {}
    metas: List[ColumnMeta] = []

    for d in dimension_cols:
        col = columns[d]
        arr = np.asarray(col)
        if arr.dtype.kind in ("U", "S", "O"):
            if d not in dicts:
                dicts[d] = DimensionDict.build(list(col))
            codes = dicts[d].encode(list(col))
        elif d in dicts:
            # caller contract: an integer column WITH a supplied dictionary is
            # already dictionary-encoded (codes), whatever the dict's kind —
            # the fast path for pre-flattened star datasources (workloads/).
            # No cast here: the shared narrowing below normalizes the width
            # (zero-copy when the caller already encodes narrow)
            codes = arr
        else:
            raw = arr.astype(np.int64)
            uniq = np.unique(raw[raw >= 0]) if len(raw) else raw
            dicts[d] = DimensionDict(values=tuple(int(v) for v in uniq))
            codes = dicts[d].encode_numeric(raw)
        dtype = "long" if dicts[d].numeric_values is not None else "string"
        narrow = codes.astype(code_dtype(dicts[d].cardinality), copy=False)
        if np.shares_memory(narrow, arr):
            # pre-encoded caller arrays must never alias into the
            # (immutable) segments: a later in-place mutation of the
            # caller's column would silently change query results
            narrow = narrow.copy()
        encoded[d] = narrow
        metas.append(
            ColumnMeta(d, "dimension", dtype, cardinality=dicts[d].cardinality)
        )

    for m in metric_cols:
        arr = np.asarray(columns[m])
        if arr.dtype.kind in ("i", "u", "b"):
            enc = arr.astype(np.int32)
            metas.append(ColumnMeta(m, "metric", "long"))
        else:
            enc = arr.astype(np.float32)
            metas.append(ColumnMeta(m, "metric", "double"))
        encoded[m] = enc

    time_arr = None
    if time_col is not None:
        time_arr = np.asarray(columns[time_col]).astype(np.int64)
        metas.append(ColumnMeta(time_col, "time", "timestamp"))

    segments: List[Segment] = []
    for si, start in enumerate(range(0, n, rows_per_segment)):
        stop = min(start + rows_per_segment, n)
        rows = stop - start
        n_padded = -(-rows // ROW_PAD) * ROW_PAD
        dims = {
            d: _pad_rows(encoded[d][start:stop], n_padded, NULL_ID)
            for d in dimension_cols
        }
        mets = {
            m: _pad_rows(encoded[m][start:stop], n_padded, 0) for m in metric_cols
        }
        tcol = None
        interval = None
        if time_arr is not None:
            t = time_arr[start:stop]
            interval = (int(t.min()), int(t.max())) if rows else None
            tcol = _pad_rows(t, n_padded, 0)
        valid = _pad_rows(np.ones(rows, dtype=bool), n_padded, False)
        segments.append(
            Segment(
                segment_id=f"{name}_{si:06d}",
                num_rows=rows,
                dims=dims,
                metrics=mets,
                time=tcol,
                valid=valid,
                interval=interval,
                time_name=time_col,
                uid=next(_SEGMENT_UIDS),
                stats=compute_segment_stats(dims, mets, valid),
            )
        )

    return DataSource(
        name=name,
        columns=tuple(metas),
        dicts=dicts,
        segments=tuple(segments),
        time_column=time_col,
    )


def datasource_to_numpy(ds) -> dict:
    """A datasource as a plain dict of numpy arrays and Python values, the
    form `datasource_from_numpy` takes.  Reads attributes only, so it
    exports any datasource with this module's field layout."""
    return {
        "name": ds.name,
        "time_column": ds.time_column,
        "columns": [
            {"name": c.name, "kind": c.kind, "dtype": c.dtype,
             "cardinality": c.cardinality}
            for c in ds.columns
        ],
        "dicts": {name: list(d.values) for name, d in ds.dicts.items()},
        "segments": [
            {
                "segment_id": s.segment_id,
                "num_rows": int(s.num_rows),
                "dims": {k: np.asarray(v) for k, v in s.dims.items()},
                "metrics": {k: np.asarray(v) for k, v in s.metrics.items()},
                "time": None if s.time is None else np.asarray(s.time),
                "valid": np.asarray(s.valid),
                "interval": s.interval,
                "time_name": s.time_name,
                "stats": None if s.stats is None else dict(s.stats),
            }
            for s in ds.segments
        ],
    }


def datasource_from_numpy(d: Mapping) -> DataSource:
    """Build a DataSource from the plain dict `datasource_to_numpy` makes:
    dictionaries, per-segment codes, metrics, time, validity, zone maps and
    intervals are taken as they are (no re-encoding), so the result scans
    exactly the segments the exporter held.  Arrays are copied: segments
    never alias a caller's buffers."""
    segments = []
    for s in d["segments"]:
        segments.append(Segment(
            segment_id=s["segment_id"],
            num_rows=int(s["num_rows"]),
            dims={k: np.array(v) for k, v in s["dims"].items()},
            metrics={k: np.array(v) for k, v in s["metrics"].items()},
            time=None if s["time"] is None else np.array(s["time"], dtype=np.int64),
            valid=np.array(s["valid"], dtype=bool),
            interval=None if s["interval"] is None else tuple(
                int(x) for x in s["interval"]
            ),
            time_name=s["time_name"],
            uid=next(_SEGMENT_UIDS),
            stats=None if s["stats"] is None else {
                k: (float(lo), float(hi)) for k, (lo, hi) in s["stats"].items()
            },
        ))
    return DataSource(
        name=d["name"],
        columns=tuple(ColumnMeta(**c) for c in d["columns"]),
        dicts={
            name: DimensionDict(values=tuple(vals))
            for name, vals in d["dicts"].items()
        },
        segments=tuple(segments),
        time_column=d["time_column"],
    )
