"""Bounded caches for device residency and query lowerings.

An unbounded cache of device columns runs a long session over many
datasources out of device memory.  Two policies:

* `ByteBudgetCache` — LRU keyed on array byte size; evicts least-recently-
  used entries until under budget.  Used for device column residency.
  Dropping the entry frees the device buffer (tensors are refcounted) once
  nothing else holds it: `on_evict(key, value)` runs for every entry the
  cache drops (budget eviction, `pop`, `del`, an overwrite; `clear` drops
  in bulk and calls nothing), so an owner of other references to the value
  (a captured CUDA graph) can let go of them first.
* `CountBudgetCache` — LRU on entry count, for the lowering cache (each
  entry pins staged device constants).

Both are dict-shaped (getitem/setitem/contains/del/iteration) so call sites
read like the plain dicts they replace.  Operations are individually
thread-safe (an RLock guards the OrderedDict), so one engine can serve
queries from several threads; hot paths must use the atomic `get`/`pop`
(check-then-`[]` from separate calls can race an eviction into KeyError).
Cross-operation atomicity (get-then-insert) is NOT provided — the caches
hold idempotent values (lowerings, device columns keyed by content), so a
racing double-insert is waste, not corruption.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional


class ByteBudgetCache:
    def __init__(self, budget_bytes: int, on_evict: Optional[Callable] = None):
        self.budget_bytes = int(budget_bytes)
        self._od: "OrderedDict[Any, Any]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.RLock()
        self._on_evict = on_evict

    def _dropped(self, key, value) -> None:
        if self._on_evict is not None:
            self._on_evict(key, value)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def __getitem__(self, key):
        with self._lock:
            v = self._od[key]
            self._od.move_to_end(key)
            return v

    def __setitem__(self, key, arr):
        with self._lock:
            if key in self._od:
                old = self._od.pop(key)
                self._bytes -= int(old.nbytes)
                self._dropped(key, old)
            self._od[key] = arr
            self._bytes += int(arr.nbytes)
            self._evict()

    def set_budget(self, budget_bytes: int) -> None:
        """A new byte budget, the least recently used entries past it
        evicted at once."""
        with self._lock:
            self.budget_bytes = int(budget_bytes)
            self._evict()

    def __delitem__(self, key):
        with self._lock:
            old = self._od.pop(key)
            self._bytes -= int(old.nbytes)
            self._dropped(key, old)

    def get(self, key, default=None):
        """Atomic hit-or-default (check-then-[] from another thread can race
        an eviction; this cannot)."""
        with self._lock:
            if key not in self._od:
                return default
            v = self._od[key]
            self._od.move_to_end(key)
            return v

    def touch(self, keys) -> None:
        """Marks `keys` most recently used, as a read of each would (keys
        not held are skipped): a reader that holds the values elsewhere (a
        captured CUDA graph) keeps its entries as warm as a `get` would."""
        with self._lock:
            for key in keys:
                if key in self._od:
                    self._od.move_to_end(key)

    def pop(self, key, default=None):
        with self._lock:
            if key not in self._od:
                return default
            v = self._od.pop(key)
            self._bytes -= int(v.nbytes)
            self._dropped(key, v)
            return v

    def __iter__(self) -> Iterator:
        with self._lock:
            return iter(list(self._od))

    def __len__(self) -> int:
        return len(self._od)

    def values(self):
        with self._lock:
            return list(self._od.values())

    def clear(self):
        with self._lock:
            self._od.clear()
            self._bytes = 0

    def _evict(self):
        # never evict the just-inserted entry: a single over-budget column
        # must still execute (the caller holds a live reference anyway).
        # Takes the (reentrant) lock itself rather than assuming the caller
        # holds it — implicit caller-holds-the-lock contracts rot
        with self._lock:
            while self._bytes > self.budget_bytes and len(self._od) > 1:
                key, old = self._od.popitem(last=False)
                self._bytes -= int(old.nbytes)
                self._dropped(key, old)


class CountBudgetCache:
    def __init__(self, budget_entries: int):
        self.budget_entries = int(budget_entries)
        self._od: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.RLock()

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def __getitem__(self, key):
        with self._lock:
            v = self._od[key]
            self._od.move_to_end(key)
            return v

    def __setitem__(self, key, v):
        with self._lock:
            if key in self._od:
                del self._od[key]
            self._od[key] = v
            while len(self._od) > self.budget_entries:
                self._od.popitem(last=False)

    def __delitem__(self, key):
        with self._lock:
            del self._od[key]

    def get(self, key, default=None):
        """Atomic hit-or-default (check-then-[] from another thread can race
        an eviction; this cannot)."""
        with self._lock:
            if key not in self._od:
                return default
            v = self._od[key]
            self._od.move_to_end(key)
            return v

    def pop(self, key, default=None):
        with self._lock:
            if key not in self._od:
                return default
            v = self._od[key]
            del self._od[key]
            return v

    def __iter__(self) -> Iterator:
        with self._lock:
            return iter(list(self._od))

    def __len__(self) -> int:
        return len(self._od)

    def values(self):
        with self._lock:
            return list(self._od.values())

    def resize(self, budget_entries: int):
        """Set a new budget and evict LRU entries down to it (a 0 budget
        keeps nothing)."""
        with self._lock:
            self.budget_entries = max(int(budget_entries), 0)
            while len(self._od) > self.budget_entries:
                self._od.popitem(last=False)

    def clear(self):
        with self._lock:
            self._od.clear()
