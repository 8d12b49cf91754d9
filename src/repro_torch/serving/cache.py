"""Query-result LRU cache keyed on a quantized query representation
(counterpart of ``repro/serving/cache.py``).

A hit returns the stored per-query result as it was produced, so cached
answers equal freshly served ones.  Keys round the query's floats to
``decimals`` before hashing, so jitter below that step still hits.  The
endpoint name, the execution backend's identity, the corpus residency
dtype, the tuned-profile tag and the live-corpus generation are part of
the key, each length-framed so that no two field sequences collide by
sliding bytes across a boundary.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["quantized_key", "QueryCache"]


def _framed(h, data: bytes):
    """Length-prefix a variable-size field so adjacent fields can't alias."""
    h.update(len(data).to_bytes(8, "little"))
    h.update(data)


def _leaves(x) -> list:
    """Array leaves of a query in order: tensors, numpy arrays and
    numbers, through tuples (``SparseVectors``, ``FusedVectors``), lists
    and dicts (by sorted key); None parts are dropped."""
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, dict):
        return [leaf for key in sorted(x) for leaf in _leaves(x[key])]
    return [x]


def _host_array(leaf) -> np.ndarray:
    """numpy copy of a leaf; a sub-f32 tensor (bf16) is widened to f32
    first, which is exact, so its floats are quantized like any other."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def quantized_key(endpoint: str, query: Any, decimals: int = 6,
                  backend: Optional[str] = None,
                  corpus_dtype: Optional[str] = None,
                  profile: Optional[str] = None,
                  generation: Optional[int] = None) -> bytes:
    """Stable digest of (endpoint, backend identity, corpus residency
    dtype, tuned-profile tag, corpus generation, quantized query).

    Float leaves are rounded to ``decimals`` in f64 (and -0 becomes +0);
    integer leaves (sparse term ids) are hashed exactly; each leaf's
    dtype and shape are folded in.  ``generation`` is the live-corpus
    snapshot generation (``repro_torch.serving.live``): results are
    stored under the generation that produced them and looked up under
    the current one, so a hit can never be stale.  A frozen endpoint
    passes None, framed as the empty field, apart from generation 0."""
    h = hashlib.blake2b(digest_size=16)
    _framed(h, endpoint.encode())
    _framed(h, (backend or "").encode())
    _framed(h, (corpus_dtype or "").encode())
    _framed(h, (profile or "").encode())
    _framed(h, b"" if generation is None else str(int(generation)).encode())
    for leaf in _leaves(query):
        a = _host_array(leaf)
        if np.issubdtype(a.dtype, np.floating):
            # + 0.0 turns -0.0 into +0.0 (their bytes differ); jitter across
            # a rounding boundary still misses, a lost hit, never a wrong one
            a = np.round(a.astype(np.float64), decimals) + 0.0
        _framed(h, str(a.dtype).encode())
        _framed(h, np.asarray(a.shape, np.int64).tobytes())
        _framed(h, np.ascontiguousarray(a).tobytes())
    return h.digest()


class QueryCache:
    """Thread-safe LRU over quantized-query keys."""

    def __init__(self, capacity: int = 4096, decimals: int = 6):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.decimals = decimals
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict[bytes, Any]" = collections.OrderedDict()

    def key(self, endpoint: str, query: Any,
            backend: Optional[str] = None,
            corpus_dtype: Optional[str] = None,
            profile: Optional[str] = None,
            generation: Optional[int] = None) -> bytes:
        return quantized_key(endpoint, query, self.decimals, backend=backend,
                             corpus_dtype=corpus_dtype, profile=profile,
                             generation=generation)

    def get(self, key: bytes) -> Optional[Any]:
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key: bytes, value: Any):
        # hits hand out the stored value by reference: numpy leaves are made
        # read-only so that a client writing into one raises instead of
        # corrupting every later hit
        for leaf in _leaves(value):
            if isinstance(leaf, np.ndarray):
                leaf.setflags(write=False)
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
