"""Ingest: external data -> host columns ready for dictionary encoding.

pandas DataFrames, pyarrow tables, dicts of numpy arrays, and parquet/CSV
paths all normalize to a dict of row-aligned numpy columns; datetimes become
int64 epoch-ms (the Druid time convention).  A CSV file is read by the
port's native single-pass decoder (`native/csv_decode.py`), which also
dictionary-encodes its string columns (`to_columns_encoded`).  pandas reads
a CSV source only where the decoder declines it for a reason that holds
every time (no `g++`, a file the parser cannot take, not a local file);
the decline is recorded in the caller's `IngestReport` (and logged).  Any
other native failure raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..utils.log import get_logger

log = get_logger("catalog.ingest")


@dataclasses.dataclass
class IngestReport:
    """How one registration read its CSV files: `decoders` has one entry per
    file read ("native" or "pandas"), `declines` why the native decoder did
    not take a file."""

    decoders: List[str] = dataclasses.field(default_factory=list)
    declines: List[str] = dataclasses.field(default_factory=list)


def _native_csv(read, path: str, report: Optional[IngestReport]):
    """`read(path)` through the native decoder, or None after a recorded
    decline."""
    from ..native import NativeDecline

    try:
        out = read(path)
    except NativeDecline as e:
        log.info("native csv decoder declined %s (%s); reading it with pandas", path, e)
        if report is not None:
            report.declines.append(f"native csv: {e.kind}: {e}")
            report.decoders.append("pandas")
        return None
    if report is not None:
        report.decoders.append("native")
    return out


def to_columns(source) -> Dict[str, np.ndarray]:
    if isinstance(source, dict):
        return {k: np.asarray(v) for k, v in source.items()}
    import pandas as pd

    if isinstance(source, pd.DataFrame):
        return _from_pandas(source)
    if type(source).__module__.split(".")[0] == "pyarrow":
        # pyarrow Table / RecordBatch; non-tabular pyarrow values fall
        # through to the TypeError
        import pyarrow as pa

        if isinstance(source, (pa.Table, pa.RecordBatch)):
            return _from_pandas(source.to_pandas())
    if isinstance(source, str):
        if source.endswith(".parquet"):
            return _from_pandas(pd.read_parquet(source))
        if source.endswith(".csv"):
            return read_csv_columns(source)
        raise ValueError(f"unsupported source path {source!r}")
    raise TypeError(f"unsupported source type {type(source).__name__}")


def to_columns_encoded(source, report: Optional[IngestReport] = None):
    """source -> (columns, dicts), the one dispatch `register_table` calls.

    A CSV path goes through the native parse and dictionary encode: string
    columns come back as int32 rank codes over the file's sorted domain,
    with their `DimensionDict` in `dicts`.  Other sources, and a CSV the
    decoder declines, go through `to_columns` with no prebuilt
    dictionaries."""
    if isinstance(source, str) and source.endswith(".csv"):
        from ..native import csv_decode

        out = _native_csv(csv_decode.read_csv_encoded, source, report)
        if out is not None:
            return out
        return _pandas_csv(source), {}
    return to_columns(source), {}


def _from_pandas(df) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for c in df.columns:
        s = df[c]
        if str(s.dtype).startswith("datetime64"):
            out[c] = s.values.astype("datetime64[ms]").astype(np.int64)
        elif s.dtype == object or str(s.dtype) in ("string", "category"):
            out[c] = s.astype(object).values
        else:
            out[c] = s.values
    return out


def _pandas_csv(path: str) -> Dict[str, np.ndarray]:
    import pandas as pd

    return _from_pandas(pd.read_csv(path))


def read_csv_columns(path: str, report: Optional[IngestReport] = None) -> Dict[str, np.ndarray]:
    """CSV -> columns (strings decoded), through the native decoder; pandas
    after a recorded decline."""
    from ..native import csv_decode

    out = _native_csv(csv_decode.read_csv, path, report)
    return out if out is not None else _pandas_csv(path)
