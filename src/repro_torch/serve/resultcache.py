"""Content-addressed result cache for the clustering serving layer.

The north-star workload is millions of *small* clustering queries, and
repeat traffic is the norm there: the same dedup shard or query
neighbourhood arrives over and over with the same PRNG key. PIVOT is
deterministic per key — for a fixed ``(graph, key, method, num_samples,
eps)`` the engine returns bit-identical ``(labels, cost, picked)`` every
time — so a repeat request need not touch the device at all.

:class:`ResultCache` is a bounded in-memory LRU keyed by
:class:`repro_torch.core.plan.GraphFingerprint` (the canonical content hash of
the planned request — ELL rows, eligibility, exact key bytes, method/k/ε).
The store/stats split mirrors the compiled-program LRU in
:mod:`repro_torch.core.executor`: the cache owns an ``OrderedDict`` with a hard
capacity + byte bound and eviction accounting, while a live
:class:`ResultCacheStats` object is shared outward (``ClusterStats``
surfaces it) so counters are readable without poking cache internals.

Two invariants matter:

* **Only post-selection winners are stored.** The cached value is the
  argmin-of-k labels/cost/picked the engine would return from a cold
  flush, keyed on the *exact* PRNG key — never intermediate per-sample
  outputs, never results for a "close enough" key. That is what keeps a
  cache hit bit-exact with the cold path.
* **Hits are collision-checked.** The fingerprint's canonical payload is
  retained per entry and compared on every digest match; a mismatch is a
  counted collision treated as a miss, so a hash collision can never
  serve another graph's labels.

A cache instance may be shared between engines (e.g. a long-lived dedup
pipeline reusing one cache across corpora): entries are immutable after
insertion and ``get`` hands out arrays the caller's result path copies
(``result_for_plan`` re-slices with ``astype``), so sharing is safe in
the repo's single-threaded serving discipline.

A copy of the framework-free ``repro/serve/resultcache.py``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.plan import GraphFingerprint

# Flat per-entry bookkeeping charge (dict slot, dataclass, ints) so the
# byte bound cannot be gamed by many tiny entries.
_ENTRY_OVERHEAD = 256


@dataclasses.dataclass
class ResultCacheStats:
    """Live counters for one :class:`ResultCache` (shared outward through
    ``ClusterStats.result_cache``; a cache shared between engines shares
    one stats object, so these are cache-lifetime, not engine-lifetime).
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    collisions: int = 0     # digest matched, canonical payload did not
    insertions: int = 0
    entries: int = 0        # gauge: resident entries
    bytes: int = 0          # gauge: resident labels + retained payloads

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class _Entry:
    payload: bytes          # canonical bytes, compared on every hit
    labels: np.ndarray      # (n,) int32 post-selection winner
    cost: int
    picked: int
    rounds: int
    nbytes: int


class ResultCache:
    """Bounded LRU of post-selection clustering results, content-addressed.

    ``capacity`` bounds resident entries and ``max_bytes`` bounds resident
    memory (labels + retained fingerprint payloads + flat overhead);
    exceeding either evicts least-recently-used entries. An entry larger
    than ``max_bytes`` on its own is admitted and immediately evicted —
    too big to cache, counted like any other eviction.
    """

    def __init__(self, capacity: int = 4096, max_bytes: int = 64 << 20):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.stats = ResultCacheStats()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, fp: GraphFingerprint
            ) -> Optional[Tuple[np.ndarray, int, int, int]]:
        """Look up ``(labels, cost, picked, rounds)``; None on miss.

        A digest match with a different canonical payload is a detected
        hash collision: counted, treated as a miss, and the resident
        entry keeps its slot (first writer wins).
        """
        entry = self._entries.get(fp.digest)
        if entry is None:
            self.stats.misses += 1
            return None
        if entry.payload != fp.payload:
            self.stats.collisions += 1
            self.stats.misses += 1
            return None
        self._entries.move_to_end(fp.digest)
        self.stats.hits += 1
        return entry.labels, entry.cost, entry.picked, entry.rounds

    def put(self, fp: GraphFingerprint, labels: np.ndarray, cost: int,
            picked: int, rounds: int) -> None:
        """Insert one post-selection winner (idempotent per fingerprint —
        re-inserting refreshes recency and keeps the resident entry)."""
        resident = self._entries.get(fp.digest)
        if resident is not None:
            # Same fingerprint ⇒ same result by the bit-exactness
            # contract; refresh recency, don't churn bytes.
            self._entries.move_to_end(fp.digest)
            return
        owned = np.array(labels, dtype=np.int32, copy=True)
        nbytes = owned.nbytes + len(fp.payload) + _ENTRY_OVERHEAD
        self._entries[fp.digest] = _Entry(
            payload=fp.payload, labels=owned, cost=int(cost),
            picked=int(picked), rounds=int(rounds), nbytes=nbytes)
        self.stats.insertions += 1
        self.stats.bytes += nbytes
        while self._entries and (len(self._entries) > self.capacity
                                 or self.stats.bytes > self.max_bytes):
            _, evicted = self._entries.popitem(last=False)
            self.stats.bytes -= evicted.nbytes
            self.stats.evictions += 1
        self.stats.entries = len(self._entries)

    def clear(self) -> None:
        """Drop every entry (counted as evictions)."""
        self.stats.evictions += len(self._entries)
        self._entries.clear()
        self.stats.entries = 0
        self.stats.bytes = 0

    def info(self) -> dict:
        """JSON-ready counters for benchmarks and serving stats."""
        return {
            "capacity": self.capacity,
            "max_bytes": self.max_bytes,
            "entries": len(self._entries),
            "bytes": self.stats.bytes,
            "hits": self.stats.hits,
            "misses": self.stats.misses,
            "hit_rate": self.stats.hit_rate,
            "evictions": self.stats.evictions,
            "collisions": self.stats.collisions,
            "insertions": self.stats.insertions,
        }


def make_result_cache(spec) -> Optional[ResultCache]:
    """Resolve a ``ClusterBatcher(result_cache=...)`` spec.

    ``True`` → a fresh default-sized cache; ``False``/``None`` → caching
    disabled; an ``int`` → a fresh cache with that entry capacity; a
    :class:`ResultCache` instance → shared as-is (cross-engine reuse).
    """
    if spec is True:
        return ResultCache()
    if spec is False or spec is None:
        return None
    if isinstance(spec, int):
        return ResultCache(capacity=spec)
    if isinstance(spec, ResultCache):
        return spec
    raise ValueError(
        f"result_cache must be a bool, int capacity, or ResultCache "
        f"instance, got {spec!r}")


__all__ = ["ResultCache", "ResultCacheStats", "make_result_cache"]
