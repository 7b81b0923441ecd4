"""Write-ahead log of streamed appends.

`TPUOlapContext.append_rows` journals the normalized batch of domain values
(the output of `ingest.delta._normalize_rows`: strings and numbers, never
rank codes) to a per-datasource append-only log before the delta publish.
Codes are rank-assigned and shift whenever a dictionary extends, so they
are not a durable currency; domain values replayed through the same
`IngestManager._append_encoded` path rebuild the state the crashed process
published, code for code.

Record framing (little-endian, one record per append batch):

    MAGIC   4B  b"SDW1"
    len     u32 payload byte length
    seq     u64 monotone per-datasource record number
    crc32   u32 of the payload bytes
    payload len bytes

Payload: a u32 JSON-header length, the header, then the raw column
buffers.  Numeric columns ride as raw dtype bytes (the header carries the
dtype and nbytes); object and string columns ride as JSON value lists in
the header (nulls kept).  No pickle.  The bytes are the JAX package's: a
WAL written by either package replays in the other.

Durability: a record is durable once `append` returns (write, flush and
fsync come before the caller may publish or acknowledge).  A torn tail (a
crash mid-write) is found structurally on replay: a short header, a short
payload or a CRC mismatch ends the scan at the last whole record, so a
batch replays whole or not at all.

Crash sites (`resilience.checkpoint`, armable through the fault injector):
`wal.journal_write` before the record reaches the file, `wal.pre_fsync`
after write and flush but before fsync, `wal.post_fsync_pre_publish` after
fsync, and `wal.replay_record` between replayed records.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..resilience import checkpoint
from ..utils.log import get_logger

log = get_logger("ingest.wal")

MAGIC = b"SDW1"
_HEAD = struct.Struct("<4sIQI")  # magic, payload_len, seq, crc32


def encode_batch(datasource: str, cols: Dict[str, np.ndarray], n: int) -> bytes:
    """Serialize one normalized append batch into a WAL payload."""
    specs: List[dict] = []
    buffers: List[bytes] = []
    for name, arr in cols.items():
        a = np.asarray(arr)
        if a.dtype.kind == "O":
            vals = [None if _is_null(v) else _jsonable(v) for v in a]
            specs.append({"name": name, "enc": "json", "values": vals})
        else:
            raw = np.ascontiguousarray(a).tobytes()
            specs.append(
                {"name": name, "enc": "raw", "dtype": a.dtype.str,
                 "nbytes": len(raw)}
            )
            buffers.append(raw)
    header = json.dumps(
        {"datasource": datasource, "n": int(n), "cols": specs}
    ).encode()
    return struct.pack("<I", len(header)) + header + b"".join(buffers)


def decode_batch(payload: bytes) -> Tuple[str, Dict[str, np.ndarray], int]:
    """Inverse of `encode_batch`.  Raises ValueError on any structural
    damage — replay treats that as a torn tail."""
    if len(payload) < 4:
        raise ValueError("payload shorter than its header-length prefix")
    (hlen,) = struct.unpack_from("<I", payload, 0)
    if 4 + hlen > len(payload):
        raise ValueError("payload header truncated")
    header = json.loads(payload[4:4 + hlen].decode())
    cols: Dict[str, np.ndarray] = {}
    off = 4 + hlen
    for spec in header["cols"]:
        if spec["enc"] == "json":
            cols[spec["name"]] = np.asarray(spec["values"], dtype=object)
        else:
            nb = int(spec["nbytes"])
            if off + nb > len(payload):
                raise ValueError("payload column buffer truncated")
            cols[spec["name"]] = np.frombuffer(
                payload[off:off + nb], dtype=np.dtype(spec["dtype"])
            ).copy()  # frombuffer views are read-only; encoders may sort
            off += nb
    if off != len(payload):
        raise ValueError("payload carries trailing bytes")
    return header["datasource"], cols, int(header["n"])


def _is_null(v) -> bool:
    if v is None:
        return True
    try:
        import pandas as pd

        return bool(pd.isna(v))
    except (TypeError, ValueError):
        return False


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.str_, str)):
        return str(v)
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    return v


class WriteAheadLog:
    """One datasource's append journal.

    All mutation happens under the owning ingest buffer's lock (the WAL
    is part of the append critical section); the internal lock only
    guards the lazily opened file handle against interleaved writers in
    direct-use tests."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self._fh = None
        self._next_seq = 0
        if os.path.exists(path):
            # seed the sequence counter past the last whole record so a
            # restarted process never reuses a seq
            last = -1
            for seq, _, _, _ in self.scan():
                last = seq
            self._next_seq = last + 1

    @property
    def last_seq(self) -> int:
        """Seq of the last durable record; -1 when the log is empty."""
        with self._lock:
            return self._next_seq - 1

    def _handle(self):
        if self._fh is None or self._fh.closed:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            # append mode: the journal is the one file of the storage
            # tier written in place rather than by atomic rename
            self._fh = open(self.path, "ab")
        return self._fh

    def append(self, datasource: str, cols: Dict[str, np.ndarray],
               n: int) -> int:
        """Journal one batch durably; returns its seq.  The caller may
        publish/ack only after this returns."""
        payload = encode_batch(datasource, cols, n)
        with self._lock:
            seq = self._next_seq
            record = _HEAD.pack(
                MAGIC, len(payload), seq, zlib.crc32(payload)
            ) + payload
            checkpoint("wal.journal_write")
            fh = self._handle()
            fh.write(record)
            fh.flush()
            checkpoint("wal.pre_fsync")
            if self.fsync:
                os.fsync(fh.fileno())
            checkpoint("wal.post_fsync_pre_publish")
            self._next_seq = seq + 1
            return seq

    # -- replay ---------------------------------------------------------------

    def scan(self) -> Iterator[Tuple[int, str, Dict[str, np.ndarray], int]]:
        """Yield (seq, datasource, cols, n) for every whole record; stop
        cleanly at the first torn/short/corrupt tail record.  Damage in
        the MIDDLE of the log (crc mismatch followed by more data) also
        stops the scan — everything after a corrupt record is
        unordered garbage by the framing contract."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            while True:
                head = fh.read(_HEAD.size)
                if len(head) < _HEAD.size:
                    return  # clean EOF or torn header
                magic, plen, seq, crc = _HEAD.unpack(head)
                if magic != MAGIC:
                    log.warning(
                        "wal %s: bad magic at offset %d; truncating scan",
                        self.path, fh.tell() - _HEAD.size,
                    )
                    return
                payload = fh.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    return  # torn or corrupt tail record: drop it whole
                try:
                    ds, cols, n = decode_batch(payload)
                except ValueError:
                    return
                yield seq, ds, cols, n

    def replay_after(
        self, watermark: int
    ) -> Iterator[Tuple[int, str, Dict[str, np.ndarray], int]]:
        """Records with seq strictly greater than `watermark` (the
        snapshot's folded-through seq; -1 replays everything)."""
        for rec in self.scan():
            # replay is a per-record loop over arbitrarily large logs:
            # honor an armed deadline / fault site between records
            checkpoint("wal.replay_record")
            if rec[0] > watermark:
                yield rec

    # -- truncation (post-compaction space reclamation) -----------------------

    def truncate_through(self, watermark: int) -> int:
        """Drop records with seq <= watermark (they are folded into the
        persisted snapshot).  Pure space reclamation: replay filters by
        the snapshot watermark anyway, so a crash that skips this loses
        nothing.  Rewrites via tmp + os.replace — the log must never be
        mid-rewrite on disk.  Returns the records kept."""
        kept = 0
        tmp = self.path + ".tmp"
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            records: List[bytes] = []
            for seq, ds, cols, n in self.scan():
                checkpoint("wal.replay_record")
                if seq > watermark:
                    payload = encode_batch(ds, cols, n)
                    records.append(
                        _HEAD.pack(MAGIC, len(payload), seq,
                                   zlib.crc32(payload)) + payload
                    )
                    kept += 1
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(tmp, "wb") as fh:
                fh.write(b"".join(records))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        return kept

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
