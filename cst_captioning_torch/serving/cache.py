"""Serving caption cache with hit/miss accounting (port of the caption
tier of the JAX package's ``serving/cache.py``).

Tier 1 (``captions``) maps a request content hash — feature bytes +
decode parameters — to the finished caption, so an identical request
never reaches the queue.  The reference's tier 2 (``feature_id`` ->
preprocessed rows + projected encoder state) feeds its scan decode and
slot loop; it comes with the continuous slot loop (ROADMAP.md Queue 1,
item 3).  The tier is a plain LRU over an ``OrderedDict`` under one
lock, bounded by entry count.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np


class LRUCache:
    """Thread-safe LRU mapping with hit/miss/eviction counters,
    bounded to ``capacity`` entries."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity {capacity} < 0")
        self.capacity = capacity
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self._hits += 1
                return self._d[key]
            self._misses += 1
            return None

    def put(self, key, value) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = value
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self._evictions += 1

    def stats(self) -> Dict[str, float]:
        with self._lock:
            hits, misses, size = self._hits, self._misses, len(self._d)
            evictions = self._evictions
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "size": size,
            "capacity": self.capacity,
            "evictions": evictions,
            "hit_rate": round(hits / total, 4) if total else 0.0,
        }


def content_key(feats: Dict[str, np.ndarray], params_tag: str) -> str:
    """Tier-1 key: sha1 over the float32 feature bytes of every modality
    in sorted order plus the decode-parameter tag — the reference's key,
    byte for byte."""
    h = hashlib.sha1()
    h.update(params_tag.encode())
    for m in sorted(feats):
        a = np.ascontiguousarray(np.asarray(feats[m], np.float32))
        h.update(m.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class TwoTierCache:
    """The reference's cache front with its caption tier (see module
    doc); ``stats()`` keeps the reference's per-tier shape."""

    def __init__(self, caption_capacity: int):
        self.captions = LRUCache(caption_capacity)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {"captions": self.captions.stats()}
