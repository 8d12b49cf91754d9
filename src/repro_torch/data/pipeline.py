"""Host-side batching and device placement (counterpart of
``repro/data/pipeline.py``).

Training input flows: numpy host data -> fixed-shape batches -> the card,
copied from pinned host memory without blocking the host.  A small
background prefetcher overlaps host batch assembly with device compute.
``lm_batches`` draws the reference's batches for the same seed.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["pad_tokens", "lm_batches", "device_put_batch", "Prefetcher"]


def pad_tokens(rows, length: int, pad_id: int) -> np.ndarray:
    out = np.full((len(rows), length), pad_id, dtype=np.int32)
    for i, r in enumerate(rows):
        r = np.asarray(r)[:length]
        out[i, : len(r)] = r
    return out


def lm_batches(token_stream: np.ndarray, batch: int, seq: int, seed: int = 0) -> Iterator[dict]:
    """Next-token-prediction batches from a flat token stream."""
    rng = np.random.default_rng(seed)
    n = len(token_stream) - seq - 1
    while True:
        starts = rng.integers(0, max(n, 1), size=batch)
        toks = np.stack([token_stream[s: s + seq] for s in starts])
        tgts = np.stack([token_stream[s + 1: s + seq + 1] for s in starts])
        yield {"tokens": toks.astype(np.int32), "targets": tgts.astype(np.int32)}


def device_put_batch(batch: dict, device=None) -> dict:
    """Each numpy array of ``batch`` as a tensor on ``device`` (None = the
    card).  To the card the copy leaves from pinned host memory and does
    not block the host; the copy is ordered before later work on the
    current stream."""
    dev = resolve_device(device)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dev.type != "cuda":
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)

    return {k: put(v) for k, v in batch.items()}


class Prefetcher:
    """Background prefetch of host batches onto ``device``, ``depth`` ahead."""

    def __init__(self, it: Iterator, device=None, depth: int = 2):
        self._it = it
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(device_put_batch(item, self._device))
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
