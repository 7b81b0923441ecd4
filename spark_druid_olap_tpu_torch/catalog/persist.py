"""Datasource persistence: encoded segments on disk, in two formats.

* `save_datasource` / `load_datasource` (`save_table` / `load_table`, and
  `CREATE TABLE t USING tpu_olap OPTIONS (path '<dir>')`): a registered
  datasource (codes, padding, dictionaries, star schema) round-trips to a
  directory, so a restart skips ingest and encoding.  Layout:
      meta.json             name, schema, time column, dictionaries, star JSON
      segment_<i>.npz       per-segment arrays: dims/metrics/time/valid
  meta.json is written last (tmp + rename): it is the commit point.
* `save_snapshot` / `load_snapshot`, the durable tier's versioned store
  (`storage.py`): one raw .npy per column per segment, named by the
  datasource version, committed by an atomic rename of snapshot.json,
  which carries everything a query plan needs without reading a column
  (schema, dictionaries, zone maps, intervals, the version, the WAL
  watermark).  A loaded column is a read-only `np.memmap`, opened on first
  access (`LazyColumnMap`): the disk tier of residency.  On a card the
  engine reads such a column from disk once, into its page-locked copy
  (`exec/pipeline.pin_host`); otherwise into an owned array
  (`materialize`) before it moves it.

Both formats are the JAX package's, byte for byte: a directory written by
either package loads in the other.  Loaded segments get fresh uids, so
device residency never aliases across loads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..obs import record_storage_load
from .segment import ColumnMeta, DataSource, DimensionDict, Segment, as_delta
from .star import StarSchemaInfo

_FORMAT_VERSION = 1
# the versioned snapshot store, a format apart from save_datasource's:
# per-column raw .npy files (np.load(mmap_mode="r") restores them as
# memmaps, so a boot reads headers, not data) and the snapshot.json commit
# point
_SNAPSHOT_VERSION = 1
SNAPSHOT_NAME = "snapshot.json"


# ---------------------------------------------------------------------------
# Atomic writes: the way the storage tier's files reach disk
# ---------------------------------------------------------------------------


def atomic_write_bytes(path: str, payload: bytes) -> str:
    """tmp + flush + fsync + os.replace: a crash at any point leaves
    either the old whole file or the new whole file, never a torn one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def atomic_write_json(path: str, obj) -> str:
    return atomic_write_bytes(path, json.dumps(obj).encode())


def atomic_write_array(path: str, arr: np.ndarray) -> str:
    """One column to one raw .npy file, atomically."""
    import io

    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr))
    return atomic_write_bytes(path, buf.getvalue())


# ---------------------------------------------------------------------------
# Lazy disk-backed columns: the third residency tier (disk -> host memory
# -> the card).  A restored segment's dims and metrics are a LazyColumnMap:
# the snapshot load opens nothing; the first `seg.column(name)` opens the
# one .npy as a read-only memmap (its header only; pages fault in as they
# are read), which the engine reads into host memory before its copy.
# ---------------------------------------------------------------------------


class LazyColumnMap(Mapping):
    """name -> ndarray Mapping over per-column .npy files, loaded (as
    memmaps) on first access and cached on the map."""

    def __init__(self, directory: str, files: Dict[str, str]):
        self._dir = directory
        self._files = dict(files)
        self._loaded: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        arr = self._loaded.get(name)
        if arr is None:
            path = os.path.join(self._dir, self._files[name])
            arr = np.load(path, mmap_mode="r")
            record_storage_load(int(arr.nbytes))
            self._loaded[name] = arr
        return arr

    def __iter__(self):
        return iter(self._files)

    def __len__(self):
        return len(self._files)

    def loaded_names(self) -> Tuple[str, ...]:
        """Which columns have actually been opened (test/obs hook)."""
        return tuple(self._loaded)


def is_disk_backed(arr) -> bool:
    """Is this host array still the disk tier (a memmap whose pages may
    not be resident)?  The engine copies such a column into host memory
    before its transfer to the card."""
    return isinstance(arr, np.memmap)


def materialize(arr: np.ndarray) -> np.ndarray:
    """Disk tier -> host RAM tier: copy a memmap into an owned array
    (no-op for arrays already in RAM)."""
    if is_disk_backed(arr):
        return np.array(arr)
    return arr


def save_datasource(
    ds: DataSource, directory: str, star: Optional[StarSchemaInfo] = None
) -> str:
    """Write segments first and meta.json last (tmp+rename): meta is the
    commit point, so an interrupted save can never pair new dictionaries
    with old rank-coded arrays (silently wrong decodes).  Stale segment
    files beyond the new count are removed."""
    os.makedirs(directory, exist_ok=True)
    meta = {
        "format_version": _FORMAT_VERSION,
        "name": ds.name,
        "time_column": ds.time_column,
        "columns": [
            {
                "name": c.name,
                "kind": c.kind,
                "dtype": c.dtype,
                "cardinality": c.cardinality,
            }
            for c in ds.columns
        ],
        "dicts": {
            name: {
                "numeric": d.numeric_values is not None,
                "values": [
                    int(v) if isinstance(v, (int, np.integer)) else str(v)
                    for v in d.values
                ],
            }
            for name, d in ds.dicts.items()
        },
        "segments": [
            {
                "segment_id": s.segment_id,
                "num_rows": s.num_rows,
                "interval": list(s.interval) if s.interval else None,
                "time_name": s.time_name,
            }
            for s in ds.segments
        ],
        "star_schema": star.to_json() if star is not None else None,
    }
    for i, seg in enumerate(ds.segments):
        arrays = {f"dim__{k}": np.asarray(v) for k, v in seg.dims.items()}
        arrays.update(
            {f"met__{k}": np.asarray(v) for k, v in seg.metrics.items()}
        )
        arrays["valid"] = np.asarray(seg.valid)
        if seg.time is not None:
            arrays["time"] = np.asarray(seg.time)
        np.savez(os.path.join(directory, f"segment_{i:06d}.npz"), **arrays)
    for f in os.listdir(directory):  # stale segments from a larger old save
        if f.startswith("segment_") and f.endswith(".npz"):
            try:
                idx = int(f[len("segment_"):-len(".npz")])
            except ValueError:
                continue
            if idx >= len(ds.segments):
                os.remove(os.path.join(directory, f))
    tmp = os.path.join(directory, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(directory, "meta.json"))
    return directory


def load_datasource(
    directory: str, name: Optional[str] = None
) -> Tuple[DataSource, Optional[StarSchemaInfo]]:
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported datasource format {meta.get('format_version')!r}"
        )
    dicts = {
        dim: DimensionDict(
            values=tuple(
                int(v) if spec["numeric"] else str(v)
                for v in spec["values"]
            )
        )
        for dim, spec in meta["dicts"].items()
    }
    columns = tuple(
        ColumnMeta(c["name"], c["kind"], c["dtype"], c["cardinality"])
        for c in meta["columns"]
    )
    segments = []
    for i, sm in enumerate(meta["segments"]):
        with np.load(os.path.join(directory, f"segment_{i:06d}.npz")) as z:
            dims = {
                k[len("dim__"):]: z[k] for k in z.files if k.startswith("dim__")
            }
            metrics = {
                k[len("met__"):]: z[k] for k in z.files if k.startswith("met__")
            }
            valid = z["valid"]
            time = z["time"] if "time" in z.files else None
        from .segment import _SEGMENT_UIDS, compute_segment_stats

        segments.append(
            Segment(
                segment_id=sm["segment_id"],
                num_rows=int(sm["num_rows"]),
                dims=dims,
                metrics=metrics,
                time=time,
                valid=valid,
                interval=tuple(sm["interval"]) if sm["interval"] else None,
                time_name=sm.get("time_name"),
                uid=next(_SEGMENT_UIDS),
                # zone maps recompute at load (one min/max pass — cheaper
                # than versioning them into the on-disk format)
                stats=compute_segment_stats(dims, metrics, valid),
            )
        )
    ds = DataSource(
        name=name or meta["name"],
        columns=columns,
        dicts=dicts,
        segments=tuple(segments),
        time_column=meta["time_column"],
    )
    star = (
        StarSchemaInfo.from_json(meta["star_schema"])
        if meta.get("star_schema")
        else None
    )
    if star is not None and ds.name != meta["name"]:
        # loading under a new name: the star's fact reference must follow,
        # or the collapse check (catalog/star.py fact_table != fact) would
        # silently reject every star join against the renamed table
        star = dataclasses.replace(star, fact_table=ds.name)
    return ds, star


# ---------------------------------------------------------------------------
# Versioned snapshot store (the durable tier, storage.py)
# ---------------------------------------------------------------------------


def _dicts_to_json(dicts) -> dict:
    return {
        name: {
            "numeric": d.numeric_values is not None,
            "values": [
                int(v) if isinstance(v, (int, np.integer)) else str(v)
                for v in d.values
            ],
        }
        for name, d in dicts.items()
    }


def _dicts_from_json(spec: dict) -> Dict[str, DimensionDict]:
    return {
        dim: DimensionDict(
            values=tuple(
                int(v) if s["numeric"] else str(v) for v in s["values"]
            )
        )
        for dim, s in spec.items()
    }


def _safe_col(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_-") else "_" for c in name)


def save_snapshot(
    ds: DataSource,
    directory: str,
    star: Optional[StarSchemaInfo] = None,
    wal_watermark: int = -1,
) -> dict:
    """Persist a datasource as the versioned snapshot store: one raw
    .npy per column per segment (named by the datasource version, so two
    generations never collide on a filename), committed by an atomic
    tmp+rename of snapshot.json.

    Ordering is the whole point: column files land durably FIRST, the
    snapshot that references them renames LAST — a crash anywhere
    in between leaves the previous snapshot fully intact (its files
    are never touched here; see `gc_snapshot_files` for retirement).
    The `persist.snapshot_rename` crash site sits between the tmp
    write and the rename: a death there recovers to the old snapshot and
    the WAL, exactly."""
    from ..resilience import checkpoint

    os.makedirs(directory, exist_ok=True)
    seg_metas: List[dict] = []
    for i, seg in enumerate(ds.segments):
        prefix = f"v{ds.version:08d}_s{i:06d}"
        files: Dict[str, str] = {}
        dim_files: Dict[str, str] = {}
        met_files: Dict[str, str] = {}
        for k, v in seg.dims.items():
            fname = f"{prefix}__dim__{_safe_col(k)}.npy"
            atomic_write_array(os.path.join(directory, fname), np.asarray(v))
            dim_files[k] = fname
        for k, v in seg.metrics.items():
            fname = f"{prefix}__met__{_safe_col(k)}.npy"
            atomic_write_array(os.path.join(directory, fname), np.asarray(v))
            met_files[k] = fname
        files["valid"] = f"{prefix}__valid.npy"
        atomic_write_array(
            os.path.join(directory, files["valid"]), np.asarray(seg.valid)
        )
        if seg.time is not None:
            files["time"] = f"{prefix}__time.npy"
            atomic_write_array(
                os.path.join(directory, files["time"]), np.asarray(seg.time)
            )
        seg_metas.append(
            {
                "segment_id": seg.segment_id,
                "num_rows": seg.num_rows,
                "interval": list(seg.interval) if seg.interval else None,
                "time_name": seg.time_name,
                "delta_seq": getattr(seg, "seq", None),
                # zone maps ride in the snapshot so boot never touches a
                # column to rebuild them (the mmap-restore speedup
                # depends on reading headers, not data)
                "stats": (
                    {k: [float(a), float(b)]
                     for k, (a, b) in seg.stats.items()}
                    if seg.stats is not None
                    else None
                ),
                "dims": dim_files,
                "mets": met_files,
                "files": files,
            }
        )
    snap = {
        "snapshot_version": _SNAPSHOT_VERSION,
        "name": ds.name,
        "time_column": ds.time_column,
        "rollup_granularity": getattr(ds, "rollup_granularity", None),
        "columns": [
            {"name": c.name, "kind": c.kind, "dtype": c.dtype,
             "cardinality": c.cardinality}
            for c in ds.columns
        ],
        "dicts": _dicts_to_json(ds.dicts),
        "ds_version": ds.version,
        "wal_watermark": int(wal_watermark),
        "star_schema": star.to_json() if star is not None else None,
        "segments": seg_metas,
    }
    path = os.path.join(directory, SNAPSHOT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f)
        f.flush()
        os.fsync(f.fileno())
    # the commit point: everything before this line is invisible to a
    # restarted process, everything after it is the new truth
    checkpoint("persist.snapshot_rename")
    os.replace(tmp, path)
    return snap


def load_snapshot(
    directory: str,
) -> Tuple[DataSource, Optional[StarSchemaInfo], int]:
    """Restore a datasource from the snapshot store WITHOUT re-encoding
    or reading column data: columns come back as LazyColumnMaps over
    .npy files (first access memmaps them), zone maps/intervals load
    from the snapshot, and the stamped datasource version is preserved.
    Returns (datasource, star, wal_watermark)."""
    from .segment import _SEGMENT_UIDS

    with open(os.path.join(directory, SNAPSHOT_NAME)) as f:
        snap = json.load(f)
    if snap.get("snapshot_version") != _SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported snapshot version {snap.get('snapshot_version')!r}"
        )
    columns = tuple(
        ColumnMeta(c["name"], c["kind"], c["dtype"], c["cardinality"])
        for c in snap["columns"]
    )
    segments: List[Segment] = []
    for sm in snap["segments"]:
        valid = np.load(
            os.path.join(directory, sm["files"]["valid"]), mmap_mode="r"
        )
        time = (
            np.load(os.path.join(directory, sm["files"]["time"]),
                    mmap_mode="r")
            if sm["files"].get("time")
            else None
        )
        seg = Segment(
            segment_id=sm["segment_id"],
            num_rows=int(sm["num_rows"]),
            dims=LazyColumnMap(directory, sm["dims"]),
            metrics=LazyColumnMap(directory, sm["mets"]),
            time=time,
            valid=valid,
            interval=tuple(sm["interval"]) if sm["interval"] else None,
            time_name=sm.get("time_name"),
            uid=next(_SEGMENT_UIDS),
            stats=(
                {k: (v[0], v[1]) for k, v in sm["stats"].items()}
                if sm.get("stats") is not None
                else None
            ),
        )
        if sm.get("delta_seq") is not None:
            seg = as_delta(seg, seq=int(sm["delta_seq"]))
        segments.append(seg)
    ds = DataSource(
        name=snap["name"],
        columns=columns,
        dicts=_dicts_from_json(snap["dicts"]),
        segments=tuple(segments),
        time_column=snap["time_column"],
        version=int(snap["ds_version"]),
    )
    if snap.get("rollup_granularity") is not None:
        ds = dataclasses.replace(
            ds, rollup_granularity=snap["rollup_granularity"]
        )
    star = (
        StarSchemaInfo.from_json(snap["star_schema"])
        if snap.get("star_schema")
        else None
    )
    return ds, star, int(snap.get("wal_watermark", -1))


def snapshot_referenced_files(directory: str) -> frozenset:
    """Filenames the CURRENT committed snapshot references."""
    path = os.path.join(directory, SNAPSHOT_NAME)
    if not os.path.exists(path):
        return frozenset()
    with open(path) as f:
        snap = json.load(f)
    refs = {SNAPSHOT_NAME}
    for sm in snap.get("segments", ()):
        refs.update(sm.get("dims", {}).values())
        refs.update(sm.get("mets", {}).values())
        refs.update(sm.get("files", {}).values())
    return frozenset(refs)


def gc_snapshot_files(directory: str) -> List[str]:
    """Delete .npy files the committed snapshot no longer references:
    compaction-retired segments leave the disk here, strictly after the
    new snapshot's rename committed.  A crash before this point leaves
    retired files as harmless orphans the next collection removes; there is
    no window where both old and new state are gone.  The `compact.retire`
    crash site sits before the deletions."""
    from ..resilience import checkpoint

    refs = snapshot_referenced_files(directory)
    removed: List[str] = []
    if not refs:
        return removed
    checkpoint("compact.retire")
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".npy"):
            continue
        if fname in refs:
            continue
        try:
            os.remove(os.path.join(directory, fname))
            removed.append(fname)
        except OSError:  # reclamation only: an orphan costs disk, not answers
            pass
    return removed


# ---------------------------------------------------------------------------
# The cluster's assignment manifest (cluster/assignment.py): the broker's
# segment -> historical replica map, committed beside the snapshots it
# indexes, so a restarted broker continues the epoch sequence.
# ---------------------------------------------------------------------------

ASSIGNMENT_MANIFEST_NAME = "cluster_assignment.json"


def save_assignment_manifest(directory: str, doc: dict) -> str:
    """Commits the assignment manifest atomically (the snapshot's rename)."""
    os.makedirs(directory, exist_ok=True)
    return atomic_write_json(os.path.join(directory, ASSIGNMENT_MANIFEST_NAME), doc)


def load_assignment_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, ASSIGNMENT_MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
