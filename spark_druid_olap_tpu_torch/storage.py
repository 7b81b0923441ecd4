"""The durable storage tier: per-datasource WALs and snapshots.

One directory per datasource under `SessionConfig.storage_dir`:

    <storage_dir>/<datasource>/
        wal.log          the append journal (ingest/wal.py): fsync'd,
                         checksummed, monotone seqs, written before the
                         delta publish, so an acknowledgement implies
                         durability
        snapshot.json    the commit point (catalog/persist.py): schema,
                         dictionaries, zone maps, star, datasource version,
                         and the WAL watermark folded into the files
        v*_s*__*.npy     one raw column per file, named by the datasource
                         version (generations never collide), restored by
                         np.load(mmap_mode="r") as the disk residency tier

Lifecycle:

* `journal_append`: called by `IngestManager.append_rows` under the
  per-datasource lock, before the publish.
* `flush_locked`: called by `Compactor.compact` (same lock) and by
  registration: the snapshot rename commits, then retired files go, then
  the WAL truncates through the folded watermark.  A crash between any two
  steps recovers exactly (the `persist.snapshot_rename` and
  `compact.retire` fault sites show it).
* `recover`: at boot, per datasource, raise the catalog's version floor,
  publish the memory-mapped snapshot (no re-encode), then replay the WAL
  records past the watermark through the path appends take.  It runs
  under the ingest admission pool, and the server answers queries 503
  with Retry-After while `replay_in_progress`: a recovering node looks
  busy, not wedged.

The tier is host code: it reads and writes the host's disk and never the
card.  The card sees its effects through the segments it publishes.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from .catalog.persist import (
    gc_snapshot_files,
    load_snapshot,
    save_snapshot,
    SNAPSHOT_NAME,
)
from .ingest.wal import WriteAheadLog
from .obs import (
    SPAN_SNAPSHOT_FLUSH,
    SPAN_WAL_APPEND,
    SPAN_WAL_REPLAY,
    record_snapshot_flush,
    record_snapshot_sweep,
    record_wal_append,
    record_wal_replay,
    span,
)
from .resilience import checkpoint
from .utils.log import get_logger

log = get_logger("storage")


def _safe_name(name: str) -> str:
    """Datasource names arrive from clients (the ingest route); the
    directory they key must not traverse."""
    return "".join(c if (c.isalnum() or c in "_-.") else "_" for c in name)


class DurableStorage:
    """One context's durable tier: per-datasource WALs + snapshots."""

    def __init__(self, root: str, catalog, ingest, fsync: bool = True):
        self.root = root
        self.catalog = catalog
        self.ingest = ingest
        self.fsync = bool(fsync)
        self._lock = threading.Lock()
        self._wals: Dict[str, WriteAheadLog] = {}
        # on-disk snapshot version per datasource (health: "what would a
        # restart restore"); updated at flush/recover
        self._snap_versions: Dict[str, int] = {}
        self.replay_in_progress = False
        self.last_recovery: Optional[dict] = None
        # the background flush sweep: a timer thread that flushes dirty
        # datasources, so a restart maps them instead of replaying
        self._sweep_stop = threading.Event()
        self._sweep_thread: Optional[threading.Thread] = None
        self._sweep_interval_s = 0.0
        self.sweeps_total = 0
        os.makedirs(root, exist_ok=True)

    # -- paths / handles -----------------------------------------------------

    def set_fsync(self, fsync: bool) -> None:
        """`SET storage_fsync`: every WAL, open or to come, takes it."""
        with self._lock:
            self.fsync = bool(fsync)
            for w in self._wals.values():
                w.fsync = self.fsync

    def dir_for(self, name: str) -> str:
        return os.path.join(self.root, _safe_name(name))

    def wal(self, name: str) -> WriteAheadLog:
        with self._lock:
            w = self._wals.get(name)
            if w is None:
                w = self._wals[name] = WriteAheadLog(
                    os.path.join(self.dir_for(name), "wal.log"),
                    fsync=self.fsync,
                )
            return w

    # -- append journal ------------------------------------------------------

    def journal_append(self, name: str, cols, n: int) -> int:
        """Journal one normalized (post-rollup) batch durably; the
        caller (append path, holding the buffer lock) publishes only
        after this returns."""
        with span(SPAN_WAL_APPEND, datasource=name, rows=n):
            seq = self.wal(name).append(name, cols, n)
        record_wal_append(name, n)
        return seq

    # -- snapshot flush ------------------------------------------------------

    def flush(self, name: str) -> dict:
        """Public flush: takes the per-datasource ingest lock (appends
        and compactions serialize against it) then commits."""
        buf = self.ingest.buffer(name)
        with buf._lock:
            return self.flush_locked(name)

    def flush_locked(self, name: str, ds=None) -> dict:
        """Snapshot the CURRENT published datasource; caller holds the
        per-datasource buffer lock.  Ordering (the crash contract):
        column files -> snapshot rename (commit) -> retired-file GC ->
        WAL truncate.  The watermark is the WAL's last seq — correct
        because under the lock every journaled record is visible in
        `ds` (as delta segments or folded rows)."""
        if ds is None:
            ds = self.catalog.get(name)
        if ds is None:
            raise KeyError(f"unknown datasource {name!r}")
        star = self.catalog.star_schema(name)
        wal = self.wal(name)
        watermark = wal.last_seq
        directory = self.dir_for(name)
        with span(SPAN_SNAPSHOT_FLUSH, datasource=name,
                  segments=len(ds.segments)):
            snap = save_snapshot(ds, directory, star, watermark)
            # retirement strictly AFTER the rename committed: a crash on
            # either side of this line loses neither old nor new state
            removed = gc_snapshot_files(directory)
            wal.truncate_through(watermark)
        with self._lock:
            self._snap_versions[name] = ds.version
        record_snapshot_flush(name, len(ds.segments))
        log.info(
            "flushed %s snapshot v%d (%d segments, wal watermark %d, "
            "%d retired files)", name, ds.version, len(ds.segments),
            watermark, len(removed),
        )
        return snap

    def snapshot_version(self, name: str) -> Optional[int]:
        """The datasource version of the last snapshot this process flushed
        or booted.  The live catalog version moves with every republish in
        one process; this one is the same in every process that shares the
        directory at the same snapshot, so the cluster pins it in its
        assignment and checks it on every scatter."""
        with self._lock:
            v = self._snap_versions.get(name)
        return int(v) if v is not None else None

    # -- background flush sweep ----------------------------------------------

    def _dirty(self, name: str) -> bool:
        """A datasource is dirty when a restart would have to REPLAY:
        its published version moved past the on-disk snapshot (delta
        appends, or a registration that raced the last flush)."""
        ds = self.catalog.get(name)
        if ds is None:
            return False
        with self._lock:
            snap = self._snap_versions.get(name)
        return snap is None or ds.version > snap

    def sweep_once(self) -> dict:
        """One deterministic sweep pass: flush every dirty datasource.
        The timer loop calls this; tests and tools can call it directly
        for a no-thread, no-sleep check of the same code path."""
        flushed: List[str] = []
        for name in list(self.catalog.tables()):
            if not self._dirty(name):
                continue
            try:
                self.flush(name)
                flushed.append(name)
            except Exception:  # one table must not stop the sweep
                log.warning(
                    "snapshot sweep flush of %s failed", name,
                    exc_info=True,
                )
        with self._lock:
            self.sweeps_total += 1
        record_snapshot_sweep(len(flushed))
        return {"flushed": flushed}

    def start_flush_sweep(self, interval_s: float) -> "DurableStorage":
        """Start the background snapshot-flush thread (idempotent)."""
        self._sweep_interval_s = float(interval_s)
        with self._lock:
            if (
                self._sweep_thread is not None
                and self._sweep_thread.is_alive()
            ):
                return self
            self._sweep_stop.clear()
            self._sweep_thread = threading.Thread(
                target=self._sweep_loop,
                name="sdol-snapshot-flush",
                daemon=True,
            )
            self._sweep_thread.start()
        return self

    def stop_flush_sweep(self) -> None:
        self._sweep_stop.set()
        t = self._sweep_thread
        if t is not None:
            t.join(timeout=10)

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self._sweep_interval_s):
            try:
                self.sweep_once()
            except Exception:  # the sweep must survive any table
                log.warning("snapshot flush sweep failed", exc_info=True)

    # -- boot recovery -------------------------------------------------------

    def _snapshot_dirs(self) -> List[str]:
        out = []
        for entry in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, entry)
            if os.path.isdir(d) and os.path.exists(
                os.path.join(d, SNAPSHOT_NAME)
            ):
                out.append(d)
        return out

    def recover(self, resilience=None) -> List[str]:
        """Restore every persisted datasource: mmap snapshot load (no
        re-encode), catalog version seeding, then WAL replay through the
        live append path.  Returns the restored names."""
        restored: List[str] = []
        totals = {"datasources": 0, "replayed_records": 0,
                  "replayed_rows": 0}
        self.replay_in_progress = True
        try:
            for directory in self._snapshot_dirs():
                name = self._recover_one(directory, resilience, totals)
                if name is not None:
                    restored.append(name)
        finally:
            self.replay_in_progress = False
            self.last_recovery = totals
        return restored

    def _recover_one(self, directory: str, resilience, totals) -> Optional[str]:
        try:
            ds, star, watermark = load_snapshot(directory)
        except (OSError, ValueError) as e:
            log.warning("snapshot load failed for %s: %s", directory, e)
            return None
        name = ds.name
        with span(SPAN_WAL_REPLAY, datasource=name):
            # version floor FIRST: the republish below must stamp a
            # version strictly above anything the pre-crash process
            # acked, or restart-spanning caches could alias
            self.catalog.seed_version(name, ds.version)
            published = self.catalog.put(ds, star)
            buf = self.ingest.buffer(name)
            with buf._lock:
                # delta seq floor: snapshot-carried delta segments keep
                # their pre-crash seqs; replayed/new appends must not
                # collide with them in segment ids
                max_seq = max(
                    (s.seq for s in published.delta_segments()), default=-1
                )
                buf._next_seq = max(buf._next_seq, max_seq + 1)
            wal = self.wal(name)
            replayed = rows = 0
            # boot replay takes an ingest admission slot: a recovering
            # node's replay competes with (and is visible as) ingest
            # load, and the query routes 503 off replay_in_progress
            pool = getattr(resilience, "ingest_admission", None)
            acquired = pool.acquire() if pool is not None else False
            try:
                for seq, _, cols, n in wal.replay_after(watermark):
                    checkpoint("storage.replay_batch")
                    self.ingest.replay_batch(name, cols)
                    replayed += 1
                    rows += n
            finally:
                if acquired:
                    pool.release()
        with self._lock:
            self._snap_versions[name] = ds.version
        totals["datasources"] += 1
        totals["replayed_records"] += replayed
        totals["replayed_rows"] += rows
        record_wal_replay(name, replayed, rows)
        log.info(
            "recovered %s: snapshot v%d + %d WAL records (%d rows)",
            name, ds.version, replayed, rows,
        )
        return name

    # -- health --------------------------------------------------------------

    def state(self) -> dict:
        """The /status/health storage section: WAL sequence, last
        snapshot version, replay-in-progress, dirty-delta counts."""
        with self._lock:
            snap_versions = dict(self._snap_versions)
            wals = dict(self._wals)
        datasources = {}
        for name in self.catalog.tables():
            ds = self.catalog.get(name)
            if ds is None:
                continue
            wal = wals.get(name)
            datasources[name] = {
                "wal_last_seq": wal.last_seq if wal is not None else -1,
                "snapshot_version": snap_versions.get(name),
                # delta segments published since the last flush: what a
                # restart would REPLAY rather than mmap
                "dirty_delta_segments": len(ds.delta_segments()),
                "dirty_delta_rows": ds.delta_rows,
            }
        return {
            "enabled": True,
            "root": self.root,
            "replay_in_progress": self.replay_in_progress,
            "datasources": datasources,
            "last_recovery": self.last_recovery,
            "flush_sweep": {
                "running": (
                    self._sweep_thread is not None
                    and self._sweep_thread.is_alive()
                ),
                "interval_s": self._sweep_interval_s,
                "sweeps_total": self.sweeps_total,
            },
        }

    def close(self) -> None:
        # join the sweep BEFORE taking the lock: a mid-flush sweep pass
        # needs `self._lock` to stamp the snapshot version
        self.stop_flush_sweep()
        with self._lock:
            for w in self._wals.values():
                w.close()
