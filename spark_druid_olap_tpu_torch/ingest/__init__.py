"""Streamed ingest: the Druid realtime-node analog.

* `ingest.shard`: sharded bulk ingest.  Per-shard, per-column workers
  factorize each shard once and merge the shards' value domains with a
  deterministic sorted union, so a bulk load scales with cores and its
  segments are row-identical to the serial `catalog.segment` build.
* `ingest.delta`: append-only delta segments.  `IngestManager.append_rows`
  encodes streamed rows into `DeltaSegment`s published through the
  catalog, so the next query sees them; every executor merges delta
  partials with historical ones through the machinery it already has.
* `ingest.compact`: versioned compaction.  Deltas roll into tiled
  historical segments; each publish bumps the datasource's version, which
  the result cache keys on, and the retired segments' uids leave the
  engine's residency, pinned copies and graphs at once.
* `ingest.wal`: the append journal the durable tier (`storage.py`) writes
  before each publish.
"""

from .compact import Compactor  # noqa: F401
from .delta import IngestManager  # noqa: F401
from .shard import (  # noqa: F401
    build_datasource_from_csv,
    build_datasource_sharded,
    encode_dimension,
    merge_shard_values,
    sharded_ingest_workers,
)
