"""ctypes bindings over the native CSV decoder (`olap_native.cc`).

* `read_csv(path)`: columns as pandas would read them (int64 where every
  field is an integer, float64 where every field is a number or a null,
  else strings as an object array with None for nulls).
* `read_csv_encoded(path)`: the same, string columns as int32 rank codes
  (null -1) plus a `DimensionDict` each (the sorted-unique domain, the
  contract of `catalog.segment`), so the segment build skips encoding.
* `encode_strings(values)`: the sorted-unique encode of a string sequence.

A path that is not a local file, or a file the parser cannot take, raises
`NativeDecline`; every other failure raises `NativeError` (`native/`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Tuple

import numpy as np

from . import NativeDecline, NativeError, load

COL_INT64, COL_DOUBLE, COL_STRING = 0, 1, 2
ERR_NONE, ERR_SHAPE = 0, 1


class _Handle:
    def __init__(self, lib, h):
        self._lib = lib
        self._h = h

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.olap_csv_free(self._h)
            self._h = None


def _open(path: str):
    if not os.path.isfile(path):
        raise NativeDecline("not_a_file", f"{path!r} is not a local file")
    lib = load()
    h = lib.olap_csv_read(os.fsencode(path))
    if not h:
        raise NativeError(f"the native decoder returned no handle for {path!r}")
    handle = _Handle(lib, h)
    err = lib.olap_csv_error(h)
    if err:
        kind = lib.olap_csv_error_kind(h)
        msg = f"csv parse error in {path!r}: {err.decode()}"
        if kind == ERR_SHAPE:
            raise NativeDecline("shape", msg)
        raise NativeError(msg)
    return lib, handle


def _columns(lib, handle, decode_strings: bool):
    from ..catalog.segment import DimensionDict

    h = handle._h
    n_rows = lib.olap_csv_num_rows(h)
    n_cols = lib.olap_csv_num_cols(h)
    if n_rows < 0 or n_cols <= 0:
        raise NativeError(f"the native decoder reported {n_rows} rows and {n_cols} columns")
    cols: Dict[str, np.ndarray] = {}
    dicts: Dict[str, DimensionDict] = {}
    for c in range(n_cols):
        name = lib.olap_csv_col_name(h, c).decode()
        t = lib.olap_csv_col_type(h, c)
        if t == COL_INT64:
            out = np.empty(n_rows, dtype=np.int64)
            lib.olap_csv_col_int64(h, c, out.ctypes.data_as(ctypes.c_void_p))
            cols[name] = out
        elif t == COL_DOUBLE:
            out = np.empty(n_rows, dtype=np.float64)
            lib.olap_csv_col_double(h, c, out.ctypes.data_as(ctypes.c_void_p))
            cols[name] = out
        elif t == COL_STRING:
            codes = np.empty(n_rows, dtype=np.int32)
            lib.olap_csv_col_codes(h, c, codes.ctypes.data_as(ctypes.c_void_p))
            k = lib.olap_csv_dict_size(h, c)
            if k < 0 or (n_rows and int(codes.max(initial=-1)) >= k):
                raise NativeError(f"column {name!r}: codes past its {k}-value dictionary")
            d = DimensionDict(values=tuple(
                lib.olap_csv_dict_value(h, c, i).decode() for i in range(k)))
            if decode_strings:
                cols[name] = d.decode(codes)
            else:
                cols[name] = codes
                dicts[name] = d
        else:
            raise NativeError(f"column {name!r} has an unknown type {t}")
    return cols, dicts


def read_csv(path: str) -> Dict[str, np.ndarray]:
    lib, handle = _open(path)
    cols, _ = _columns(lib, handle, decode_strings=True)
    return cols


def read_csv_encoded(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """(columns, dicts): string columns as rank codes over the file's domain."""
    lib, handle = _open(path)
    return _columns(lib, handle, decode_strings=False)


def encode_strings(values) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Sorted-unique dictionary encode of a string sequence (None and NaN
    are the null code -1; other values encode as `str`): (int32 codes, the
    sorted values)."""
    lib = load()
    n = len(values)
    arr = (ctypes.c_char_p * n)()
    keepalive = []
    for i, v in enumerate(values):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            arr[i] = None
        else:
            b = v.encode() if isinstance(v, str) else str(v).encode()
            keepalive.append(b)
            arr[i] = b
    h = lib.olap_dict_encode(arr, n)
    if not h:
        raise NativeError("the native encoder returned no handle")
    try:
        codes = np.empty(n, dtype=np.int32)
        lib.olap_dict_codes(h, codes.ctypes.data_as(ctypes.c_void_p))
        k = lib.olap_dict_size(h)
        vals = tuple(lib.olap_dict_value(h, i).decode() for i in range(k))
    finally:
        lib.olap_dict_free(h)
    return codes, vals
