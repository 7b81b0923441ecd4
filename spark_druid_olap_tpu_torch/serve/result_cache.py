"""Version-keyed result cache.

Dashboards post the same query every refresh.  The cache answers a repeat
with no device work at all:

  * Entries key on the query's identity, the datasource's dictionary
    signature and the session flags (never the segment uids), and carry
    the monotonic per-datasource `version` (`catalog/cache.py`) the answer
    was computed against, with the segment uids it covered.
  * A lookup at the entry's version is a hit: the final frame, copied.
  * Any other version is a miss (a re-registration, a new segment set).

Writes go through `put(...)` with a required keyword `version`: an entry
without the version it was computed at is the stale-dashboard bug this
cache exists to prevent.  The JAX package also reuses a stale entry's
partial state when only appends separate it from the live segments (delta
reuse); that needs delta segments, which come with ingest.
"""

from __future__ import annotations

import threading
from typing import FrozenSet, Optional

from ..utils.log import get_logger
from ..utils.lru import CountBudgetCache

log = get_logger("serve.result_cache")


class CacheEntry:
    __slots__ = ("df", "version", "uids", "hits")

    def __init__(self, df, version: int, uids: FrozenSet):
        self.df = df
        self.version = int(version)
        self.uids = frozenset(uids)
        self.hits = 0


class ResultCache:
    """LRU result cache of final frames."""

    def __init__(self, entries: int = 64):
        self.entries = max(int(entries), 0)
        self._cache = CountBudgetCache(max(self.entries, 1))
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        # capacity is the cache's; whether lookups happen at all is the
        # session's live decision (callers gate on
        # `config.result_cache_entries > 0` per query)
        return self._cache.budget_entries > 0

    def _count(self, outcome: str) -> None:
        from ..obs import get_registry

        with self._lock:
            if outcome == "hit":
                self.hits += 1
            else:
                self.misses += 1
        get_registry().counter(
            "sdol_result_cache_total",
            "result-cache lookups by outcome (hit = zero device "
            "dispatch; delta = cached historical ⊕ fresh delta)",
            labels=("outcome",),
        ).labels(outcome=outcome).inc()

    def get(self, key, version: int):
        """A hit at `version`: the cached final frame (a copy), or None.
        Counts only hits; the caller counts the miss once it knows no
        cached answer serves."""
        if not self.enabled:
            return None
        entry: Optional[CacheEntry] = self._cache.get(key)
        if entry is None or entry.version != int(version):
            return None
        entry.hits += 1
        self._count("hit")
        return entry.df.copy()

    def note_miss(self) -> None:
        if self.enabled:
            self._count("miss")

    def put(self, key, df, *, version: int, uids) -> None:
        """Publish one answer.  `version` (keyword-only, required) is the
        datasource version the answer was computed against; `uids` the
        segment uids it covered (what delta reuse will extend)."""
        if not self.enabled:
            return
        self._cache[key] = CacheEntry(df.copy(), version=version, uids=uids)

    def resize(self, entries: int) -> None:
        """`SET result_cache_entries`: re-budget and evict down (0 releases
        every entry and disables the cache)."""
        self.entries = max(int(entries), 0)
        self._cache.resize(self.entries)

    def clear(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._cache),
                "capacity": self.entries,
                "delta_reuse": False,
                "hits": self.hits,
                "delta_hits": 0,
                "misses": self.misses,
            }
