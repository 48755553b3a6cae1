"""Port of api_ratelimit_tpu/limiter/local_cache.py (unchanged semantics).

Host-side over-limit cache (freecache equivalent).

Once a key is known to be over its limit, the backend round-trip is skipped
for the rest of its window: the key is stored with TTL = the unit's full
duration, and — because the cache key embeds the window start — it naturally
loses effect when the window rolls (src/limiter/base_limiter.go:94-106).

Implementation: a dict with expiry timestamps, approximate-LRU eviction when
over capacity, and freecache-style gauges exported via a StatGenerator
(src/limiter/local_cache_stats.go:20-43). All operations are O(1) and
lock-guarded; this sits on the host fast path in front of the TPU batcher.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..utils.timeutil import TimeSource


class LocalCache:
    def __init__(self, max_entries: int, time_source: TimeSource):
        self._max_entries = int(max_entries)
        self._time = time_source
        self._entries: OrderedDict[str, int] = OrderedDict()  # key -> expire_at
        self._lock = threading.Lock()
        # freecache-style counters
        self.hits = 0
        self.misses = 0
        self.expired = 0
        self.evacuated = 0
        self.overwrites = 0

    def set(self, key: str, ttl_seconds: int) -> None:
        expire_at = self._time.unix_now() + int(ttl_seconds)
        with self._lock:
            if key in self._entries:
                self.overwrites += 1
                self._entries.move_to_end(key)
            self._entries[key] = expire_at
            while len(self._entries) > self._max_entries:
                self._entries.popitem(last=False)
                self.evacuated += 1

    def contains(self, key: str) -> bool:
        now = self._time.unix_now()
        with self._lock:
            expire_at = self._entries.get(key)
            if expire_at is None:
                self.misses += 1
                return False
            if expire_at <= now:
                del self._entries[key]
                self.expired += 1
                self.misses += 1
                return False
            self.hits += 1
            return True

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


class LocalCacheStats:
    """StatGenerator exporting freecache-equivalent gauges on flush
    (reference paths: ratelimit.localcache.*)."""

    def __init__(self, cache: LocalCache, scope):
        self._cache = cache
        self._gauges = {
            "hitCount": scope.gauge("hitCount"),
            "missCount": scope.gauge("missCount"),
            "lookupCount": scope.gauge("lookupCount"),
            "entryCount": scope.gauge("entryCount"),
            "expiredCount": scope.gauge("expiredCount"),
            "evacuateCount": scope.gauge("evacuateCount"),
            "overwriteCount": scope.gauge("overwriteCount"),
        }

    def generate_stats(self) -> None:
        c = self._cache
        self._gauges["hitCount"].set(c.hits)
        self._gauges["missCount"].set(c.misses)
        self._gauges["lookupCount"].set(c.hits + c.misses)
        self._gauges["entryCount"].set(c.entry_count())
        self._gauges["expiredCount"].set(c.expired)
        self._gauges["evacuateCount"].set(c.evacuated)
        self._gauges["overwriteCount"].set(c.overwrites)
