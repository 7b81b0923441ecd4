"""Metadata cache: the registry of datasources and their star schemas.

Datasources are registered (ingested) into the cache, beside the query-time
lookup tables (`LOOKUP(dim, 'name')`, Druid's lookup extraction); entries
are immutable by construction (frozen dataclasses holding arrays nobody
mutates), and `clear()` is the clear-metadata-cache command, which drops
the lookups too.  Every mutation bumps `version`, which the SQL plan cache
keys on, so a re-registered table or lookup invalidates cached rewrites.
Every publish of a datasource (a registration, a delta append, a
dictionary remap, a compaction, a retention drop, a recovery) goes through
`put` and bumps its own version, stamped on the DataSource it publishes,
which the result cache keys on.  Versions never go back: a drop keeps the
count, and recovery from disk raises the floor first (`seed_version`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from .segment import DataSource
from .star import StarSchemaInfo


class MetadataCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, DataSource] = {}
        self._stars: Dict[str, StarSchemaInfo] = {}
        # query-time lookup tables (Druid lookup extraction): name -> map
        self._lookups: Dict[str, dict] = {}
        self.version = 0
        # per-datasource publish count, monotonic across drops
        self._ds_versions: Dict[str, int] = {}

    def put_lookup(self, name: str, mapping: dict):
        with self._lock:
            self._lookups[name] = dict(mapping)
            self.version += 1

    def lookup(self, name: str):
        with self._lock:
            return self._lookups.get(name)

    def put(self, ds: DataSource, star: Optional[StarSchemaInfo] = None):
        """Publish a datasource (and its star schema, when given), stamped
        with its next version.  Returns the published DataSource."""
        with self._lock:
            v = self._ds_versions.get(ds.name, 0) + 1
            self._ds_versions[ds.name] = v
            ds = dataclasses.replace(ds, version=v)
            self._tables[ds.name] = ds
            if star is not None:
                self._stars[ds.name] = star
            self.version += 1
        return ds

    def datasource_version(self, name: str) -> int:
        """The datasource's publish count (0: never published)."""
        with self._lock:
            return self._ds_versions.get(name, 0)

    def seed_version(self, name: str, version: int) -> None:
        """Raise the datasource's version floor (never lowers it).  Boot
        recovery seeds it from the persisted snapshot before republishing,
        so versions stay monotonic across restarts: an answer cached at a
        pre-crash version N never meets another segment set stamped N."""
        with self._lock:
            self._ds_versions[name] = max(self._ds_versions.get(name, 0), int(version))

    def get(self, name: str) -> Optional[DataSource]:
        with self._lock:
            return self._tables.get(name)

    def star_schema(self, name: str) -> Optional[StarSchemaInfo]:
        with self._lock:
            return self._stars.get(name)

    def star_schemas(self) -> Dict[str, StarSchemaInfo]:
        """Every registered star schema, by fact datasource (a copy)."""
        with self._lock:
            return dict(self._stars)

    def tables(self):
        with self._lock:
            return list(self._tables)

    def drop(self, name: str):
        with self._lock:
            self._tables.pop(name, None)
            self._stars.pop(name, None)
            self.version += 1

    def clear(self):
        with self._lock:
            self._tables.clear()
            self._stars.clear()
            self._lookups.clear()
            self.version += 1
