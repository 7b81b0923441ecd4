"""Version-keyed result cache with delta-aware reuse.

Dashboards post the same query every refresh, and a realtime datasource
takes appends between refreshes.  Every aggregate state is mergeable, so:

  * Entries key on the query's identity, the datasource's dictionary
    signature and the session flags (never the segment uids), and carry
    the monotonic per-datasource `version` (`catalog/cache.py`) the answer
    was computed against, the segment uids it covered and, where the
    execution produced one, its merged host partial state.
  * A lookup at the entry's version is a hit: the final frame, copied, no
    device work.
  * A lookup at a later version whose entry holds a state and covers a
    strict subset of the live segment uids (segments were appended, none
    retired) can be reused (`reusable_entry`): the engine scans only the
    new segments, the two states merge, and the refreshed entry is cached
    at the new version (`serve/core.py`), so an append costs its deltas,
    not the history.
  * A retired uid (a compaction, or a remap that kept the key), an entry
    without a state (the adaptive or sparse tier answered, or the state
    was over `_STATE_BYTES_MAX`), or a dictionary extension (the key
    changes) is a full miss.  A fused batch's member keeps its own copy of
    its state.

Writes go through `put(...)` with a required keyword `version`: an entry
without the version it was computed at is the stale-dashboard bug this
cache exists to prevent.
"""

from __future__ import annotations

import threading
from typing import FrozenSet, Optional

from ..utils.log import get_logger
from ..utils.lru import CountBudgetCache

log = get_logger("serve.result_cache")

# partial states larger than this are not kept (a cached [G, M] state is
# host memory held per entry): the entry keeps its frame alone
_STATE_BYTES_MAX = 32 << 20


def _state_nbytes(state) -> int:
    if state is None:
        return 0
    total = sum(int(getattr(state[k], "nbytes", 0)) for k in ("sums", "mins", "maxs"))
    return total + sum(int(getattr(v, "nbytes", 0)) for v in state.get("sketches", {}).values())


class CacheEntry:
    __slots__ = ("df", "state", "version", "uids", "hits", "delta_hits")

    def __init__(self, df, state, version: int, uids: FrozenSet):
        self.df = df
        self.state = state
        self.version = int(version)
        self.uids = frozenset(uids)
        self.hits = 0
        self.delta_hits = 0


class ResultCache:
    """LRU result cache of final frames and their mergeable partial states."""

    def __init__(self, entries: int = 64, delta_reuse: bool = True):
        self.entries = max(int(entries), 0)
        self.delta_reuse = bool(delta_reuse)
        self._cache = CountBudgetCache(max(self.entries, 1))
        self._lock = threading.Lock()
        self.hits = 0
        self.delta_hits = 0
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
            elif outcome == "delta":
                self.delta_hits += 1
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

    def reusable_entry(self, key, version: int, current_uids):
        """(entry, decline): the entry a delta refresh can extend (present,
        at an earlier version, holding a partial state, covering a strict
        subset of the live uids: segments were appended and none retired),
        else None with the reason it cannot ("" when there is no entry or
        it is at this version)."""
        if not self.enabled:
            return None, ""
        entry: Optional[CacheEntry] = self._cache.get(key)
        if entry is None or entry.version == int(version):
            return None, ""
        if entry.state is None:
            return None, "result-cache: the cached answer holds no partial state to merge"
        if not entry.uids < frozenset(current_uids):
            return None, ("result-cache: segments retired since the cached version "
                          "(a compaction or a remap)")
        return entry, ""

    def note_delta_hit(self, entry: CacheEntry) -> None:
        entry.delta_hits += 1
        self._count("delta")

    def note_miss(self) -> None:
        if self.enabled:
            self._count("miss")

    def put(self, key, df, *, version: int, uids, state=None) -> None:
        """Publish one answer.  `version` (keyword-only, required) is the
        datasource version the answer was computed against; `uids` the
        segment uids it covered; `state` its merged host partial state,
        when the execution produced one (what delta reuse extends)."""
        if not self.enabled:
            return
        if state is not None and _state_nbytes(state) > _STATE_BYTES_MAX:
            log.info("partial state too large to keep (%d B); caching the frame alone",
                     _state_nbytes(state))
            state = None
        self._cache[key] = CacheEntry(df.copy(), state, version=version, uids=uids)

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
                "delta_reuse": self.delta_reuse,
                "hits": self.hits,
                "delta_hits": self.delta_hits,
                "misses": self.misses,
            }
