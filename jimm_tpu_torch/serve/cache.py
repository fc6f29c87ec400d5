"""LRU cache for text-tower class/prompt embeddings; the port's copy of
``jimm_tpu/serve/cache.py`` (the same keys for the same token rows).

Zero-shot classification against a fixed label set pays the text tower once
per *label set*, not once per request: the ensemble classifier weights from
``utils/zero_shot.py`` depend only on (model, tokenized prompts). Keying a
small LRU on exactly that tuple lets repeat label sets skip the text encoder
entirely — the inference hot path stays the single ``(B, D) @ (D, C)``
matmul. Values are host ``np.ndarray``s (not device tensors) so a cache
full of stale label sets never pins device memory.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable

import numpy as np


def prompt_set_key(model_key: str, rows) -> str:
    """Stable cache key for a prompt set under one model.

    ``model_key`` names the weights (checkpoint path / preset + dtype);
    ``rows`` is the ``(N, L)`` int token matrix — its bytes subsume both the
    tokenizer (same text, different tokenizer => different ids) and the
    prompt set itself.
    """
    rows = np.ascontiguousarray(np.asarray(rows, np.int64))
    h = hashlib.sha256()
    h.update(model_key.encode())
    h.update(str(rows.shape).encode())
    h.update(rows.tobytes())
    return h.hexdigest()


class EmbeddingCache:
    """Thread-safe LRU mapping prompt-set keys to embedding matrices.

    Hit/miss/eviction counters (``stats()``); ``get_or_build`` is the
    only API the hot path needs.
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: OrderedDict[str, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str) -> np.ndarray | None:
        with self._lock:
            value = self._data.get(key)
            if value is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: str, value: np.ndarray) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def get_or_build(self, key: str,
                     builder: Callable[[], np.ndarray]) -> np.ndarray:
        """Return the cached value, building (and inserting) it on a miss.
        The builder runs outside the lock — a slow text-tower encode must
        not serialize unrelated lookups."""
        value = self.get(key)
        if value is not None:
            return value
        value = np.asarray(builder())
        self.put(key, value)
        return value

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"cache_entries": len(self._data), "cache_hits": self.hits,
                "cache_misses": self.misses, "cache_evictions": self.evictions,
                "cache_hit_rate": round(self.hit_rate, 4)}


#: process-wide default cache for class embeddings, shared by the CLI
#: `classify` command (repeat invocations in one process reuse weights) and
#: the serving stack's zero-shot endpoint
_DEFAULT_CACHE: EmbeddingCache | None = None
_DEFAULT_LOCK = threading.Lock()


def class_embedding_cache() -> EmbeddingCache:
    global _DEFAULT_CACHE
    with _DEFAULT_LOCK:
        if _DEFAULT_CACHE is None:
            _DEFAULT_CACHE = EmbeddingCache(capacity=32)
        return _DEFAULT_CACHE
