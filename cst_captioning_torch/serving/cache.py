"""Two-tier serving cache with hit/miss accounting (port of the JAX
package's ``serving/cache.py``).

Tier 1 (``captions``) maps a request content hash — feature bytes +
decode parameters — to the finished caption, so an identical request
never reaches the queue.  Tier 2 (``features``) maps a client-supplied
``feature_id`` to the request's preprocessed feature rows and, once the
slot loop's admission encode has run, its projected encoder rows (one
row of each ``DecodeCache`` field), so a repeat request that only names
the id skips the feature upload, the preprocessing and the admission
encode.

Both tiers are plain LRU over an ``OrderedDict`` under one lock per
tier, bounded by entry count (``serving.caption_cache_size`` /
``feature_cache_size``) and, for tier 2, whose values are feature rows
of hundreds of KB, by bytes (``feature_cache_bytes``): every ``put``
sizes the entry (:func:`entry_nbytes`) and evicts least-recently-used
entries until the tier fits the budget.  Evictions are counted and
exported on ``/metrics``.  Values are host memory — numpy arrays and CPU
tensors, never device tensors — so an eviction frees real memory, and a
row stored by a replica on one card admits on any other.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np
import torch


def entry_nbytes(value: Any) -> int:
    """Host bytes held by a cache value: numpy arrays and tensors count
    their elements' bytes, containers recurse (+64 each), everything
    else a flat 64 (keys, strings, ints, None)."""
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, torch.Tensor):
        return int(value.numel() * value.element_size())
    if isinstance(value, dict):
        return sum(entry_nbytes(v) for v in value.values()) + 64
    if isinstance(value, (list, tuple)):
        return sum(entry_nbytes(v) for v in value) + 64
    return 64


class LRUCache:
    """Thread-safe LRU mapping with hit/miss/eviction counters.

    ``capacity`` bounds entries; ``max_bytes`` (0 = unbounded) also
    bounds the summed :func:`entry_nbytes` of the values."""

    def __init__(self, capacity: int, max_bytes: int = 0):
        if capacity < 0:
            raise ValueError(f"capacity {capacity} < 0")
        if max_bytes < 0:
            raise ValueError(f"max_bytes {max_bytes} < 0")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self._sizes: Dict[Any, int] = {}
        self._bytes = 0
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
        size = entry_nbytes(value) if self.max_bytes else 0
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self._bytes -= self._sizes.get(key, 0)
            self._d[key] = value
            self._sizes[key] = size
            self._bytes += size
            # LRU first until both bounds hold; an entry larger than the
            # whole budget evicts itself.
            while self._d and (
                    len(self._d) > self.capacity
                    or (self.max_bytes and self._bytes > self.max_bytes)):
                k, _ = self._d.popitem(last=False)
                self._bytes -= self._sizes.pop(k, 0)
                self._evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def __contains__(self, key) -> bool:
        # A membership probe: recency and counters stay as they are.
        with self._lock:
            return key in self._d

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._sizes.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            hits, misses, size = self._hits, self._misses, len(self._d)
            evictions, nbytes = self._evictions, self._bytes
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "size": size,
            "capacity": self.capacity,
            "bytes": nbytes,
            "max_bytes": self.max_bytes,
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
    """``captions`` (tier 1) + ``features`` (tier 2); see module doc.
    ``feature_max_bytes`` bounds tier 2 only: tier-1 values are short
    strings, whose entry count is the honest bound."""

    def __init__(self, caption_capacity: int, feature_capacity: int = 0,
                 feature_max_bytes: int = 0):
        self.captions = LRUCache(caption_capacity)
        self.features = LRUCache(feature_capacity, feature_max_bytes)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {"captions": self.captions.stats(),
                "features": self.features.stats()}
