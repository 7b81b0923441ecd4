"""Sharded bulk ingest: a two-phase pipeline beside the serial build.

The serial build (`catalog.segment.build_datasource`) dictionary-encodes
every row of a string dimension by binary search against the sorted value
domain, one chunk at a time.  Here:

* **Phase 1, dictionaries.**  Each (shard, dimension) worker factorizes
  its shard once (`pandas.factorize` / `numpy.unique`: local uniques and
  int codes).  The local domains merge with a deterministic sorted union
  (`merge_shard_values`), so the dictionary is a function of the row set
  alone, whatever the shard count or the order workers finish in, and each
  shard's codes remap through a per-shard LUT.  String comparisons are
  left only over each shard's distinct values.
* **Phase 2, segments.**  Each shard (`rows_per_segment` rows) goes through
  `build_datasource` with its codes and the global dictionaries, so the
  padded, zone-mapped segments are the ones the serial build makes; shards
  reassemble in order, so the output is row-identical to the serial build
  (uids apart).

Workers are threads (`concurrent.futures.ThreadPoolExecutor`): the hot
loops are numpy and pandas C loops that release the GIL.  One worker runs
inline (`_InlineExecutor`).  CSV files are read by the native decoder
(`native/csv_decode.py`), whose per-file rank codes are a finished phase 1
(`build_datasource_from_csv`).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..catalog.segment import (
    DataSource,
    DimensionDict,
    NULL_ID,
    Segment,
    build_datasource,
)
from ..resilience import checkpoint
from ..utils.log import get_logger

log = get_logger("ingest.shard")

# shards the workers may hold finished ahead of the (ordered) consumer:
# peak host memory stays at about (workers + slack) encoded shards
_INFLIGHT_SLACK = 2


class _InlineExecutor:
    """An executor that runs submissions inline, for one worker: a thread
    pool there buys no overlap (an object-dtype factorize holds the GIL)
    and costs hand-offs."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        class _Done:
            __slots__ = ("_v",)

            def __init__(self, v):
                self._v = v

            def result(self):
                return self._v

        return _Done(fn(*args))


def sharded_ingest_workers(workers: Optional[int] = None) -> int:
    """The worker count: the argument, else the CPU count."""
    if workers is not None and workers > 0:
        return int(workers)
    return max(1, os.cpu_count() or 1)


def encode_dimension(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Factorize ONE shard of one dimension: `(local_codes int32,
    local_values)` where `local_values` are the shard's distinct non-null
    values and `local_codes[i]` indexes into it (NULL_ID for nulls —
    None/NaN on object columns, negative raw values on integer columns,
    matching the serial encoder's null contract)."""
    import pandas as pd

    a = np.asarray(arr)
    if a.dtype.kind in ("i", "u"):
        uniq, inv = np.unique(a.astype(np.int64), return_inverse=True)
        codes = inv.astype(np.int32)
        n_neg = int(np.searchsorted(uniq, 0))  # negatives sort first
        if n_neg:
            codes = np.where(codes < n_neg, NULL_ID, codes - n_neg)
            uniq = uniq[n_neg:]
        return codes, uniq
    inv, uniq = pd.factorize(a)  # -1 for NaN/None: exactly NULL_ID
    return inv.astype(np.int32), np.asarray(uniq, dtype=object)


def global_codes(
    local_codes: np.ndarray, local_values, d: DimensionDict
) -> np.ndarray:
    """Remap a shard's local factorize codes into `d`'s global code space
    through a uniques-sized LUT — the only dictionary lookups paid are one
    per DISTINCT shard value, and those go through the dictionary's OWN
    vectorized encoders (searchsorted over the sorted domain), so the LUT
    build is O(uniques · log(card)), never a per-value linear scan.
    Values absent from `d` become NULL_ID (the serial encoder's
    out-of-domain contract)."""
    vals = np.asarray(local_values)
    if len(vals) == 0:
        lut = np.empty(1, dtype=np.int32)
    elif d.numeric_values is not None or (
        not d.values and vals.dtype.kind in "iu"
    ):
        lut = d.encode_numeric(vals.astype(np.int64))
    else:
        lut = d.encode(list(vals))
    out = np.where(
        local_codes >= 0, lut[np.maximum(local_codes, 0)], NULL_ID
    )
    return out.astype(np.int32)


def merge_shard_values(per_shard_values: Sequence) -> DimensionDict:
    """Deterministic dictionary merge: sorted union of the shards' local
    value domains — the same sorted-domain contract `DimensionDict.build`
    produces serially, independent of sharding."""
    seen: set = set()
    for vals in per_shard_values:
        for v in vals:
            if v is None or (isinstance(v, float) and v != v):
                continue
            seen.add(v)
    if seen and all(
        isinstance(v, (int, np.integer)) and not isinstance(v, bool)
        for v in seen
    ):
        return DimensionDict(values=tuple(sorted(int(v) for v in seen)))
    return DimensionDict(values=tuple(sorted(str(v) for v in seen)))


def _reshard(chunks: Iterable[Mapping], rows_per_shard: int):
    """Re-chunk an iterable of column mappings into exact
    `rows_per_shard`-row shards (tail shard may be short) — shard
    boundaries then coincide with segment boundaries, which is what makes
    the sharded output identical to the serial one."""
    buf: Optional[Dict[str, List[np.ndarray]]] = None
    buffered = 0
    for chunk in chunks:
        cols = {k: np.asarray(v) for k, v in chunk.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        lo = 0
        while lo < n:
            take = min(n - lo, rows_per_shard - buffered)
            part = {k: v[lo:lo + take] for k, v in cols.items()}
            lo += take
            if buf is None and take == rows_per_shard:
                yield part  # zero-copy fast path: chunk aligned to shard
                continue
            if buf is None:
                buf = {k: [v] for k, v in part.items()}
            else:
                for k, v in part.items():
                    buf[k].append(v)
            buffered += take
            if buffered == rows_per_shard:
                yield {k: np.concatenate(v) for k, v in buf.items()}
                buf, buffered = None, 0
    if buf is not None:
        yield {k: np.concatenate(v) for k, v in buf.items()}


def _read_csv_file(path: str):
    """One CSV file -> (columns, per-file dicts, its IngestReport): the native
    parse and dictionary encode, string columns as int32 rank codes over the
    file's sorted domain; pandas (no dictionaries) after a recorded
    decline."""
    from ..catalog.ingest import IngestReport, to_columns_encoded

    report = IngestReport()
    cols, dicts = to_columns_encoded(path, report)
    return cols, dicts, report


def build_datasource_from_csv(
    name: str,
    paths: Sequence[str],
    dimension_cols: Sequence[str],
    metric_cols: Sequence[str],
    time_col: Optional[str] = None,
    rows_per_segment: int = 1 << 22,
    dicts: Optional[Mapping[str, DimensionDict]] = None,
    workers: Optional[int] = None,
    report=None,
) -> DataSource:
    """Bulk-build a DataSource from CSV files, one file per phase-1 shard.

    The native decoder's output for a file is a finished phase-1
    factorize: int32 rank codes over the file's sorted domain, the (local
    codes, local values) the factorize workers make.  The files parse in
    parallel (threads; the native parse releases the GIL), their domains
    merge with the deterministic sorted union, each file's codes remap
    through a LUT, and the chunks feed `build_datasource_sharded` in order:
    the output is row-, code- and stats-identical to concatenating the
    files through the serial build.

    A dimension takes that path only when every file came with a native
    dictionary for it and the caller gave none; otherwise its codes decode
    back to values and phase 1 encodes them again.  Time columns must
    already be numeric (epoch ms), as on the dict and array paths.
    `report` (a `catalog.ingest.IngestReport`) gets each file's decoder and
    declines, in file order."""
    workers = sharded_ingest_workers(workers)
    pool_cls = ThreadPoolExecutor if workers > 1 else _InlineExecutor
    paths = list(paths)
    if not paths:
        raise ValueError("csv ingest needs at least one file")
    dicts = dict(dicts) if dicts else {}
    with pool_cls(max_workers=workers) as pool:
        futs = [pool.submit(_read_csv_file, p) for p in paths]
        files = []
        for fut in futs:
            checkpoint("ingest.csv_file")
            cols, fdicts, frep = fut.result()
            files.append((cols, fdicts))
            if report is not None:
                report.decoders.extend(frep.decoders)
                report.declines.extend(frep.declines)
    # dimensions every file pre-encoded (and no caller dictionary): merge
    # the per-file domains and remap, phase 1 is done
    native_dims = [
        d for d in dimension_cols
        if d not in dicts and all(d in fdicts for _, fdicts in files)
    ]
    for d in native_dims:
        dicts[d] = merge_shard_values([fdicts[d].values for _, fdicts in files])
    chunks: List[Dict[str, np.ndarray]] = []
    for cols, fdicts in files:
        cols = dict(cols)
        for d, fdict in fdicts.items():
            if d in native_dims:
                cols[d] = global_codes(
                    np.asarray(cols[d]), np.asarray(fdict.values, dtype=object), dicts[d])
            else:
                # typed differently across files, or under a caller
                # dictionary: ranks over this file's domain only, so decode
                # to values and let phase 1 encode them
                cols[d] = fdict.decode(np.asarray(cols[d]))
        chunks.append(cols)
    return build_datasource_sharded(
        name,
        chunks,
        dimension_cols=dimension_cols,
        metric_cols=metric_cols,
        time_col=time_col,
        rows_per_segment=rows_per_segment,
        dicts=dicts,
        workers=workers,
    )


def build_datasource_sharded(
    name: str,
    source,
    dimension_cols: Sequence[str],
    metric_cols: Sequence[str],
    time_col: Optional[str] = None,
    rows_per_segment: int = 1 << 22,
    dicts: Optional[Mapping[str, DimensionDict]] = None,
    workers: Optional[int] = None,
) -> DataSource:
    """Bulk-build a DataSource on the sharded two-phase pipeline.

    `source` is one column mapping or an iterable of column-mapping chunks.
    Missing dictionaries are built in phase 1 (per-shard factorize and the
    deterministic merge), which `build_datasource_streamed` cannot do (it
    needs global dictionaries up front).  The segments hold the rows,
    codes, dictionaries and zone maps of the serial `build_datasource`."""
    workers = sharded_ingest_workers(workers)
    pool_cls = ThreadPoolExecutor if workers > 1 else _InlineExecutor
    if isinstance(source, Mapping):
        source = [source]
    shards: List[Optional[Dict[str, np.ndarray]]] = list(
        _reshard(source, rows_per_segment)
    )
    if not shards:
        raise ValueError("sharded ingest produced no rows")
    dicts = dict(dicts) if dicts else {}

    # phase 1: every dimension without a caller dictionary gets factorized
    # per shard and merged — integer dims included (a per-shard dictionary
    # would not share a code space across shards)
    need = [d for d in dimension_cols if d not in dicts]
    # string-typed dims WITH a caller dictionary also pre-encode here (the
    # factorize-once path beats the serial per-row encode); pre-encoded
    # integer code columns pass through untouched
    pre = [
        d for d in dimension_cols
        if d not in need and np.asarray(shards[0][d]).dtype.kind in "OUS"
    ]
    encoded: Dict[Tuple[int, str], np.ndarray] = {}
    if need or pre:
        with pool_cls(max_workers=workers) as pool:
            futs = {
                (si, d): pool.submit(encode_dimension, shards[si][d])
                for si in range(len(shards))
                for d in need + pre
            }
            local: Dict[Tuple[int, str], Tuple[np.ndarray, np.ndarray]] = {}
            for key, fut in futs.items():
                checkpoint("ingest.dict_shard")
                local[key] = fut.result()
        for d in need:
            dicts[d] = merge_shard_values(
                [local[(si, d)][1] for si in range(len(shards))]
            )
        with pool_cls(max_workers=workers) as pool:
            remap_futs = {
                key: pool.submit(global_codes, codes, uniq, dicts[key[1]])
                for key, (codes, uniq) in local.items()
            }
            for key, fut in remap_futs.items():
                checkpoint("ingest.remap_shard")
                encoded[key] = fut.result()
        del local

    first_meta: List = []

    def encode_shard(si: int) -> List[Segment]:
        cols = dict(shards[si])
        for d in need + pre:
            cols[d] = encoded.pop((si, d))
        part = build_datasource(
            name,
            cols,
            dimension_cols=list(dimension_cols),
            metric_cols=list(metric_cols),
            time_col=time_col,
            rows_per_segment=rows_per_segment,
            dicts=dicts,
        )
        shards[si] = None  # release the raw shard promptly
        if not first_meta:
            first_meta.append(part.columns)
        return list(part.segments)

    segments: List[Segment] = []
    with pool_cls(max_workers=workers) as pool:
        pending: List = []
        si = 0
        n_shards = len(shards)
        while si < n_shards or pending:
            while si < n_shards and len(pending) < workers + _INFLIGHT_SLACK:
                pending.append(pool.submit(encode_shard, si))
                si += 1
            # ordered reassembly: shard i's segments precede shard i+1's
            checkpoint("ingest.encode_shard")
            for s in pending.pop(0).result():
                segments.append(
                    dataclasses.replace(
                        s, segment_id=f"{name}_{len(segments):06d}"
                    )
                )
    log.info(
        "sharded ingest %s: %d rows -> %d segments (%d workers)",
        name, sum(s.num_rows for s in segments), len(segments), workers,
    )
    return DataSource(
        name=name,
        columns=first_meta[0],
        dicts=dicts,
        segments=tuple(segments),
        time_column=time_col,
    )
