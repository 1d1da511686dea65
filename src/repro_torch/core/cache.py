"""Small bounded LRU cache for built artifacts.

The scorer cache (``api.get_scorer``) is backed by this LRU with an
eviction counter (surfaced through ``api.scorer_cache_stats``), so a
long-lived process cannot grow it without bound.

Keys that must survive while in active use (e.g. an evaluator whose run
generators are still live) can be *pinned*: pinned entries are skipped
when choosing an eviction victim, and the cache is allowed to exceed its
capacity transiently while everything is pinned.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable


class LRUCache:
    """Least-recently-used mapping with a capacity, pins and an eviction
    counter.  ``get``/``__getitem__``/``__setitem__`` refresh recency."""

    def __init__(self, capacity: int, on_evict: Callable | None = None):
        if capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.evictions = 0
        self._on_evict = on_evict
        self._data: OrderedDict = OrderedDict()
        self._pins: dict = {}           # key -> pin count

    # -- mapping ----------------------------------------------------------
    def __contains__(self, key) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self):
        return iter(self._data)

    def __getitem__(self, key):
        self._data.move_to_end(key)
        return self._data[key]

    def get(self, key, default=None):
        if key not in self._data:
            return default
        return self[key]

    def __setitem__(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        self._shrink()

    def pop(self, key, *default):
        self._pins.pop(key, None)
        return self._data.pop(key, *default)

    def clear(self) -> None:
        self._data.clear()
        self._pins.clear()

    # -- pinning ----------------------------------------------------------
    def pin(self, key) -> None:
        """Protect ``key`` from eviction until :meth:`unpin` (refcounted)."""
        if key not in self._data:
            raise KeyError(key)
        self._pins[key] = self._pins.get(key, 0) + 1

    def unpin(self, key) -> None:
        n = self._pins.get(key, 0) - 1
        if n <= 0:
            self._pins.pop(key, None)
            self._shrink()
        else:
            self._pins[key] = n

    def pinned(self, key) -> bool:
        return self._pins.get(key, 0) > 0

    # -- capacity ---------------------------------------------------------
    def set_capacity(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"LRU capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._shrink()

    def _shrink(self) -> None:
        while len(self._data) > self.capacity:
            victim = next((k for k in self._data if not self.pinned(k)),
                          None)
            if victim is None:          # everything pinned: overflow for now
                return
            value = self._data.pop(victim)
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(victim, value)
