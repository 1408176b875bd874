"""LRU result cache of fold serving, keyed by the feature digest
(counterpart of ``repro/serve/result_cache.py``).

Folding draws no random numbers, so a request's feature digest
(``data.featurize.feature_digest``) identifies its result: a hit answers
the request without a step on the card.  Entries are stored by reference;
nothing in the serving path writes to a ``FoldResult`` after its harvest.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional


class ResultCache:
    """LRU {feature digest -> FoldResult} with hit / miss / eviction
    counters."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._d: "OrderedDict[str, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, digest: str) -> Optional[object]:
        hit = self._d.get(digest)
        if hit is None:
            self.misses += 1
            return None
        self._d.move_to_end(digest)
        self.hits += 1
        return hit

    def put(self, digest: str, result) -> None:
        if digest in self._d:
            self._d.move_to_end(digest)
        self._d[digest] = result
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, digest: str) -> bool:
        return digest in self._d

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._d),
                "capacity": self.capacity, "hit_rate": round(self.hit_rate, 4)}
