"""Ingest: external data -> host columns ready for dictionary encoding.

pandas DataFrames, pyarrow tables, dicts of numpy arrays, and parquet/CSV
paths all normalize to a dict of row-aligned numpy columns; datetimes become
int64 epoch-ms (the Druid time convention).  CSV is read through pandas: the
native single-pass CSV decoder of the JAX package (`native/`, whose
`to_columns_encoded` returns pre-encoded columns) is not ported yet, and the
JAX package reads CSV the same way when it is absent.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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


def read_csv_columns(path: str) -> Dict[str, np.ndarray]:
    import pandas as pd

    return _from_pandas(pd.read_csv(path))
