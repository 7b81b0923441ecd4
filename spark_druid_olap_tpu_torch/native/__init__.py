"""The port's native (C++) host code, bound with ctypes: the single-pass CSV
parse and dictionary encode of `olap_native.cc` (`csv_decode.py`).

The source is the port's own copy.  On first use it is compiled with
`g++ -O3 -std=c++17 -shared -fPIC -pthread` into `build/native/` at the
repository root (beside the CUDA kernel's `build/torch_ext/`; git ignores `build/`),
under a name that carries a hash of the source and the flags, so an edited
source never loads a stale library.  The temporary output is renamed into
place, so processes that build at once do not clash.

Two outcomes are kept apart.  A `NativeDecline` is a deterministic reason
the decoder does not take a source: no `g++` on PATH, a file the parser
cannot take (ragged rows, an unterminated quote, no header), a source that
is not a local file.  Its caller reads the source with pandas and records
the reason (`catalog.ingest.IngestReport`).
Anything else is a `NativeError` and raises: a failed compile, a library
that does not load or has another ABI, a missing handle, an I/O error, a
result whose shape makes no sense.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "olap_native.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
ABI_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeDecline(Exception):
    """The decoder does not take this source, for a reason that holds every
    time (`kind`: "no_compiler", "shape" or "not_a_file"); the caller reads
    it with pandas and records the reason."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


class NativeError(RuntimeError):
    """A failure of the native layer: it raises, never falls back."""


def _compiler() -> str:
    found = shutil.which("g++")
    if found is None:
        raise NativeDecline("no_compiler", "no g++ on PATH to build the native CSV decoder")
    return found


def build() -> Path:
    """Compile the library if this source has not been built yet; returns its
    path.  No `g++` declines; a failed compile raises."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"olap_native_{tag}.so"
    if out.exists():
        return out
    cxx = _compiler()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeError(f"cannot load {path}: {e}") from e
            try:
                _declare(lib)
            except AttributeError as e:
                raise NativeError(f"{path} lacks a symbol: {e}") from e
            if lib.olap_abi_version() != ABI_VERSION:
                raise NativeError(f"{path} has ABI {lib.olap_abi_version()}, "
                                  f"expected {ABI_VERSION}")
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library loads here (False on a decline: no `g++`)."""
    try:
        load()
    except NativeDecline:
        return False
    return True


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "olap_csv_read": ([c.c_char_p], c.c_void_p),
        "olap_csv_error": ([c.c_void_p], c.c_char_p),
        "olap_csv_error_kind": ([c.c_void_p], c.c_int),
        "olap_csv_num_rows": ([c.c_void_p], c.c_longlong),
        "olap_csv_num_cols": ([c.c_void_p], c.c_int),
        "olap_csv_col_name": ([c.c_void_p, c.c_int], c.c_char_p),
        "olap_csv_col_type": ([c.c_void_p, c.c_int], c.c_int),
        "olap_csv_col_int64": ([c.c_void_p, c.c_int, c.c_void_p], None),
        "olap_csv_col_double": ([c.c_void_p, c.c_int, c.c_void_p], None),
        "olap_csv_col_codes": ([c.c_void_p, c.c_int, c.c_void_p], None),
        "olap_csv_dict_size": ([c.c_void_p, c.c_int], c.c_int),
        "olap_csv_dict_value": ([c.c_void_p, c.c_int, c.c_int], c.c_char_p),
        "olap_csv_free": ([c.c_void_p], None),
        "olap_dict_encode": ([c.POINTER(c.c_char_p), c.c_longlong], c.c_void_p),
        "olap_dict_codes": ([c.c_void_p, c.c_void_p], None),
        "olap_dict_size": ([c.c_void_p], c.c_int),
        "olap_dict_value": ([c.c_void_p, c.c_int], c.c_char_p),
        "olap_dict_free": ([c.c_void_p], None),
        "olap_abi_version": ([], c.c_int),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
