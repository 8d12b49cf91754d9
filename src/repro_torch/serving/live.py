"""Live corpora: insert / delete / upsert behind a serving endpoint
(counterpart of ``repro/serving/live.py``).

``LiveCorpus`` wraps the segment algebra of ``core.segments`` with what
serving needs: mutation order under a writer lock, an immutable snapshot
swapped in one attribute assignment (a reader pins a snapshot once per
batch and finishes on it), a background compactor thread that
materializes main + append - tombstones and warms the main ANN index
off the lock before the swap, and freshness metrics.

Concurrency:

- **Writers** (``insert`` / ``delete`` / ``upsert``) serialize on one
  lock; each batch builds a whole new ``SegmentSnapshot`` with
  ``generation + 1`` and swaps it in.
- **Readers** call :meth:`LiveCorpus.snapshot` (or go through
  ``LiveGenerator``, which pins a snapshot per batch) and never block
  writers.
- **The compactor** captures a snapshot and the version of every live
  id, materializes and warms outside the lock, then re-enters it to
  reconcile what landed meanwhile (rows upserted or deleted since are
  tombstoned in the new main; rows appended since become the new append
  tail) and swaps.  Generations stay strictly monotone.

Device: the corpus lives on ``device`` (None means the CUDA card, and
raises without one; pass ``device="cpu"`` for the plain versions), and
inserted rows, numpy or tensors, move there.  Writers, the compactor and
readers may run on different CUDA streams (a served endpoint's batches
run on its worker's own stream): every published snapshot carries an
event recorded on the stream that built it, and :meth:`LiveCorpus.snapshot`
makes the reader's current stream wait for it, so a batch never reads a
segment still being written.  It also marks the snapshot's segments as
used by the reader's stream (``record_stream``): a segment dropped by a
swap while a batch's reads of it are still queued is not handed to
another allocation until that stream has passed them.  Nothing waits for
the card on the host.

The logical-id bookkeeping (``repro``'s two Python dicts) is held in
sorted numpy arrays, so building it over millions of rows, and the
compactor's reconciliation, are vectorised.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import segments
from repro_torch.core.backends import (CudaBackend, ReferenceBackend, StreamingBackend,
                                       backend_identity, invalidate_ann_index_entries,
                                       resolve_backend)
from repro_torch.core.brute_force import TopK
from repro_torch.core.segments import SegmentSnapshot
from repro_torch.core.spaces import (canonical_dtype, cast_corpus, corpus_dtype, map_tensors,
                                     tensor_leaves)
from repro_torch.device import resolve_device

__all__ = ["LiveCorpus", "LiveGenerator", "SnapshotGenerator"]

_EXACT_BACKENDS = (ReferenceBackend, StreamingBackend, CudaBackend)

_GONE, _MAIN, _APPEND = 0, 1, 2


class _IdTable:
    """Every logical id ever seen, sorted, with its segment (gone, main or
    append), physical row and version (bumped by each insert, upsert and
    delete of the id)."""

    def __init__(self, ids: np.ndarray):
        order = np.argsort(ids, kind="stable")
        self.keys = ids[order]
        self.seg = np.full(len(ids), _MAIN, dtype=np.int8)
        self.pos = order.astype(np.int64)
        self.ver = np.zeros(len(ids), dtype=np.int64)

    def find(self, ids: np.ndarray) -> np.ndarray:
        """Slots of ``ids``; -1 for an id never seen."""
        if not len(self.keys):
            return np.full(len(ids), -1, dtype=np.int64)
        j = np.minimum(np.searchsorted(self.keys, ids), len(self.keys) - 1)
        return np.where(self.keys[j] == ids, j, -1)

    def add(self, ids: np.ndarray):
        """Add unseen unique ids as gone, at version -1 (their first
        insert or upsert makes it 0)."""
        ids = np.sort(ids)
        at = np.searchsorted(self.keys, ids)
        self.keys = np.insert(self.keys, at, ids)
        self.seg = np.insert(self.seg, at, _GONE)
        self.pos = np.insert(self.pos, at, 0)
        self.ver = np.insert(self.ver, at, -1)


def _on_device(rows, device: torch.device):
    """A corpus (tensors, numpy arrays, or a ``SparseVectors`` /
    ``FusedVectors`` of them) with every leaf on ``device``; the same
    object when it is already there."""
    if rows is None:
        return None
    if isinstance(rows, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    if isinstance(rows, torch.Tensor):
        here = rows.device.type == device.type and (
            device.index is None or rows.device.index == device.index)
        return rows if here else rows.to(device)
    if isinstance(rows, tuple) and hasattr(rows, "_fields"):
        moved = [_on_device(x, device) for x in rows]
        return rows if all(a is b for a, b in zip(moved, rows)) else type(rows)(*moved)
    raise TypeError(f"not a corpus: {type(rows).__name__}")


class LiveCorpus:
    """A mutable corpus served through generation-versioned segments.

    ``backend`` serves the frozen main segment (any registered backend,
    ``graph_ann``/``napp`` included: their lazily built indexes are keyed
    by the main corpus object, which changes only at compaction).
    ``append_backend`` scans the append segment and must be exact
    (reference / streaming / cuda).

    ``max_append`` / ``max_dead`` bound the append segment and the
    tombstone count: crossing either triggers a compaction, handed to the
    background thread once :meth:`start` has run and run inline on the
    mutating thread otherwise.  Bounded tombstones also bound the extra
    fetch depth of ``live_topk`` (``k + tombstones``), which keeps ANN
    budgets (``ef``) sufficient under churn."""

    def __init__(self, space, corpus=None, *, ids=None,
                 backend: Any = "reference",
                 append_backend: Any = "reference",
                 corpus_dtype: Optional[str] = None,
                 max_append: int = 1024,
                 max_dead: Optional[int] = None,
                 compact_interval_s: Optional[float] = None,
                 device=None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.space = space
        self.device = resolve_device(device)
        self._time = time_fn
        self.max_append = int(max_append)
        self.max_dead = None if max_dead is None else int(max_dead)
        self.compact_interval_s = compact_interval_s

        self._dtype = canonical_dtype(corpus_dtype) if corpus_dtype is not None else None
        corpus = _on_device(corpus, self.device)
        if corpus is not None and self._dtype is not None:
            corpus = cast_corpus(corpus, self._dtype)

        self.main_backend = (resolve_backend(backend, space, corpus) if corpus is not None
                             else resolve_backend(backend))
        self.append_backend = resolve_backend(append_backend)
        if not isinstance(self.append_backend, _EXACT_BACKENDS):
            raise ValueError(
                "append_backend must be exact (reference/streaming/cuda): "
                "the append segment is scanned, not indexed; got "
                f"{backend_identity(self.append_backend)!r}")

        n = 0
        if corpus is not None:
            n = segments._rows(corpus)
            if n is None:
                raise ValueError("corpus is not a row-major corpus")
        if ids is None:
            ids = np.arange(n, dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64)
            if len(ids) != n or len(np.unique(ids)) != n:
                raise ValueError("ids must be unique and match the corpus row count")
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        self._snapshot = self._published(SegmentSnapshot(
            generation=0, main=corpus, main_ids=ids, main_dead=np.zeros(n, dtype=bool)))
        self._ids = _IdTable(ids)
        self._next_id = int(ids.max()) + 1 if n else 0
        self._swapped_at = self._time()
        self._compactions = 0
        self._compaction_s: collections.deque = collections.deque(maxlen=128)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> SegmentSnapshot:
        """The current immutable state.  Hold the reference for the whole
        batch: everything computed from one snapshot is consistent and
        survives any number of concurrent swaps.  On the card, the
        caller's current stream is ordered after the work that built it."""
        snap = self._snapshot
        ready = getattr(snap, "_ready", None)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            if stream != snap._built_on:
                for leaf in tensor_leaves(snap.main) + tensor_leaves(snap.append):
                    leaf.record_stream(stream)
        return snap

    @property
    def generation(self) -> int:
        return self._snapshot.generation

    @property
    def corpus_dtype(self) -> Optional[str]:
        if self._dtype is not None:
            return self._dtype
        snap = self._snapshot
        return corpus_dtype(snap.main if snap.main is not None else snap.append)

    def topk(self, queries, k: int) -> TopK:
        """Search the current snapshot (logical ids; see
        ``segments.live_topk``)."""
        return segments.live_topk(self.space, self.snapshot(), queries, k,
                                  main_backend=self.main_backend,
                                  append_backend=self.append_backend)

    def live_stats(self) -> Dict[str, Any]:
        """Freshness metrics."""
        snap = self._snapshot
        return {
            "generation": snap.generation,
            "segment_rows": {"main": snap.n_main, "append": snap.n_append},
            "tombstones": snap.n_dead,
            "snapshot_age_s": self._time() - self._swapped_at,
            "compactions": self._compactions,
            "compaction_s": list(self._compaction_s),
        }

    # -- mutation -----------------------------------------------------------
    def _published(self, snap: SegmentSnapshot) -> SegmentSnapshot:
        """``snap`` with the current stream, where its segments were built,
        and an event recorded on it (on the card only)."""
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            ready = torch.cuda.Event()
            ready.record(stream)
            object.__setattr__(snap, "_ready", ready)
            object.__setattr__(snap, "_built_on", stream)
        return snap

    def _swap(self, snap: SegmentSnapshot):
        # caller holds self._lock
        self._snapshot = self._published(snap)
        self._swapped_at = self._time()

    def _coerce_rows(self, rows):
        rows = _on_device(rows, self.device)
        m = segments._rows(rows)
        if not m:
            raise ValueError("rows must be a row-major corpus with at least one row")
        if self._dtype is None:
            self._dtype = corpus_dtype(rows)
        elif corpus_dtype(rows) != self._dtype:
            rows = cast_corpus(rows, self._dtype)
        return rows, m

    def insert(self, rows) -> np.ndarray:
        """Append ``rows`` (a row-major corpus) as new documents; returns
        their newly assigned logical ids."""
        rows, m = self._coerce_rows(rows)
        with self._lock:
            snap = self.snapshot()
            new_ids = np.arange(self._next_id, self._next_id + m, dtype=np.int64)
            self._next_id += m
            base = snap.n_append
            self._swap(SegmentSnapshot(
                generation=snap.generation + 1,
                main=snap.main, main_ids=snap.main_ids, main_dead=snap.main_dead,
                append=segments.concat_rows(snap.append, rows),
                append_ids=np.concatenate([snap.append_ids, new_ids]),
                append_dead=np.concatenate([snap.append_dead, np.zeros(m, dtype=bool)])))
            self._ids.add(new_ids)
            slots = self._ids.find(new_ids)
            self._ids.seg[slots] = _APPEND
            self._ids.pos[slots] = base + np.arange(m)
            self._ids.ver[slots] += 1
        self._maybe_compact()
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone the given logical ids.  Raises ``KeyError``, and
        changes nothing, on an id that is not live (an id named twice is
        not live the second time).  Returns the number of rows
        tombstoned."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        with self._lock:
            snap = self.snapshot()
            slots = self._ids.find(ids)
            dead = slots < 0
            dead[~dead] = self._ids.seg[slots[~dead]] == _GONE
            _, first = np.unique(ids, return_index=True)
            repeat = np.ones(len(ids), dtype=bool)
            repeat[first] = False
            bad = dead | repeat
            if bad.any():
                raise KeyError(f"id {int(ids[np.argmax(bad)])} is not live")
            main_dead = snap.main_dead.copy()
            append_dead = snap.append_dead.copy()
            seg, pos = self._ids.seg[slots], self._ids.pos[slots]
            main_dead[pos[seg == _MAIN]] = True
            append_dead[pos[seg == _APPEND]] = True
            self._ids.seg[slots] = _GONE
            self._ids.ver[slots] += 1
            self._swap(dataclasses.replace(snap, generation=snap.generation + 1,
                                           main_dead=main_dead, append_dead=append_dead))
        self._maybe_compact()
        return len(ids)

    def upsert(self, ids, rows) -> np.ndarray:
        """Insert-or-replace: each ``(id, row)`` pair replaces the live row
        of that logical id (tombstoning the superseded physical row) or
        inserts a fresh document under that id; an id named twice in one
        batch keeps its last row.  Logical ids are stable across upserts
        and epochs."""
        rows, m = self._coerce_rows(rows)
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if len(ids) != m:
            raise ValueError(f"{len(ids)} ids for {m} rows")
        with self._lock:
            snap = self.snapshot()
            main_dead = snap.main_dead.copy()
            append_dead = snap.append_dead.copy()
            base = snap.n_append
            uniq, inverse, counts = np.unique(ids, return_inverse=True, return_counts=True)
            last = np.zeros(len(uniq), dtype=np.int64)
            np.maximum.at(last, inverse, np.arange(m))
            new_dead = np.arange(m) != last[inverse]      # superseded in this same batch
            self._ids.add(uniq[self._ids.find(uniq) < 0])
            slots = self._ids.find(uniq)
            seg, pos = self._ids.seg[slots], self._ids.pos[slots]
            main_dead[pos[seg == _MAIN]] = True
            append_dead[pos[seg == _APPEND]] = True
            self._ids.seg[slots] = _APPEND
            self._ids.pos[slots] = base + last
            self._ids.ver[slots] += counts
            self._next_id = max(self._next_id, int(uniq[-1]) + 1)
            self._swap(SegmentSnapshot(
                generation=snap.generation + 1,
                main=snap.main, main_ids=snap.main_ids, main_dead=main_dead,
                append=segments.concat_rows(snap.append, rows),
                append_ids=np.concatenate([snap.append_ids, ids]),
                append_dead=np.concatenate([append_dead, new_dead])))
        self._maybe_compact()
        return ids

    # -- compaction ---------------------------------------------------------
    def _maybe_compact(self):
        snap = self._snapshot
        over = (snap.n_append >= self.max_append
                or (self.max_dead is not None and snap.n_dead >= self.max_dead))
        if not over:
            return
        if self._thread is not None and self._thread.is_alive():
            self._wake.set()
        else:
            self.compact()

    def compact(self) -> bool:
        """Materialize main + append - tombstones into a fresh main segment
        and swap it in.  The expensive part (the row gather and warming the
        main ANN index) runs outside the writer lock; mutations that land
        meanwhile are reconciled at the swap (their superseded rows
        tombstoned in the new main, their new rows carried over as the
        append tail).  Returns False when there was nothing to compact."""
        with self._compact_lock:
            t0 = self._time()
            with self._lock:
                snap0 = self.snapshot()
                if snap0.n_append == 0 and snap0.n_dead == 0:
                    return False
                vers0 = self._ids.ver[self._ids.find(snap0.live_ids())]
            corpus, ids = segments.materialize(snap0)
            if corpus is not None and hasattr(self.main_backend, "_index"):
                # warm the lazily built ANN index off the lock, so that the
                # new main is servable the moment it is swapped in
                self.main_backend._index(self.space, corpus, len(ids))
            with self._lock:
                cur = self.snapshot()
                slots = self._ids.find(ids)
                main_dead = (self._ids.seg[slots] == _GONE) | (self._ids.ver[slots] != vers0)
                tail_lo = snap0.n_append
                tail_ids = cur.append_ids[tail_lo:]
                tail = (None if not len(tail_ids)
                        else map_tensors(lambda x: x[tail_lo:], cur.append))
                self._swap(SegmentSnapshot(
                    generation=cur.generation + 1,
                    main=corpus, main_ids=ids, main_dead=main_dead,
                    append=tail, append_ids=tail_ids,
                    append_dead=cur.append_dead[tail_lo:]))
                moved = (self._ids.seg == _APPEND) & (self._ids.pos >= tail_lo)
                self._ids.pos[moved] -= tail_lo
                rows = np.nonzero(~main_dead)[0]
                self._ids.seg[slots[rows]] = _MAIN
                self._ids.pos[slots[rows]] = rows
                retired = snap0.main
            self._compactions += 1
            self._compaction_s.append(self._time() - t0)
            # drop only the retired main's index entries; batches still
            # pinning the old snapshot keep its corpus and index alive
            if retired is not None and retired is not corpus:
                invalidate_ann_index_entries(retired)
            return True

    # -- background compactor / lifecycle -----------------------------------
    def start(self) -> "LiveCorpus":
        """Start the background compactor thread (idempotent).  It wakes on
        threshold triggers and every ``compact_interval_s`` (if set)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._compactor_loop,
                                            name="live-compactor", daemon=True)
            self._thread.start()
        return self

    def _compactor_loop(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=self.compact_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            snap = self._snapshot
            if snap.n_append or snap.n_dead:
                self.compact()

    def close(self):
        """Stop the compactor thread and wait for an in-flight compaction
        to finish (the corpus stays queryable)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "LiveCorpus":
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass(frozen=True)
class SnapshotGenerator:
    """A candidate generator frozen at one snapshot: everything the batch
    computes comes from one logical state."""

    live: LiveCorpus
    snap: SegmentSnapshot

    def generate(self, query_repr, k: int) -> TopK:
        return segments.live_topk(self.live.space, self.snap, query_repr, k,
                                  main_backend=self.live.main_backend,
                                  append_backend=self.live.append_backend)


class LiveGenerator:
    """Candidate generator over a :class:`LiveCorpus`.

    ``RetrievalPipeline`` calls :meth:`bind_snapshot` once per batch
    (``pipeline.pin_snapshot``), so a batch finishes on the snapshot it
    started with whatever mutations or compactions race it.
    ``last_served_generation`` records the pinned generation, which
    stamps cache keys."""

    def __init__(self, live: LiveCorpus):
        self.live = live
        self.last_served_generation: Optional[int] = None

    @property
    def backend(self):
        return self.live.main_backend

    @property
    def corpus_dtype(self) -> Optional[str]:
        return self.live.corpus_dtype

    def bind_snapshot(self) -> SnapshotGenerator:
        snap = self.live.snapshot()
        self.last_served_generation = snap.generation
        return SnapshotGenerator(self.live, snap)

    def generate(self, query_repr, k: int) -> TopK:
        return self.bind_snapshot().generate(query_repr, k)
