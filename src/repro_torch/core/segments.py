"""Segment algebra for live (mutable) corpora (counterpart of
``repro/core/segments.py``).

A corpus under mutation is a generation-versioned pair of segments:

- a frozen **main segment** (any row-major corpus: a tensor,
  ``SparseVectors`` or ``FusedVectors``), served through any registered
  execution backend, the lazily indexed ANN backends included, and
- a bounded **append segment** of the rows inserted since the last
  compaction, scanned exactly (reference / streaming / cuda),

plus per-row **tombstone** flags on both (a delete or an upsert marks
the superseded physical row dead without touching the tensors the
backends score).  Every mutation batch makes a whole new
``SegmentSnapshot`` with ``generation + 1``, so a reader holding one can
never see half a batch.  Nothing here locks, starts a thread or reads a
clock: ``repro_torch.serving.live.LiveCorpus`` owns mutation order, the
background compactor and the epoch swap.

Frozen equivalence: for exact backends, :func:`live_topk` over a
snapshot equals, ids and score bits, a search of the corpus
materialized at the same logical state (:func:`materialize` +
:func:`frozen_topk`).  Each segment is fetched deep enough to absorb its
tombstones (``k + dead rows``), dead candidates are masked to -inf, and
main-then-append concatenation reproduces the tie-break toward the lower
materialized row.  Final scores are rescored through
``space.score_pairs`` at the same ``(B * k,)`` pair shape on both sides,
because two differently segmented scans of one corpus need not agree in
the last bit (summation order differs with the shape), while two
identically shaped pair rescores of the same rows do.  When ``k >
n_live`` the tail is ``_reference_tail``'s: -inf scores and ids
``n_live, n_live + 1, ...``.

A fetch deeper than the scan kernels' 2048 goes, like any other k, to
the backend, which serves it (the ``cuda`` backend through
``kernels.topk_large``).  The segment's logical ids and tombstone flags
reach the device once per snapshot and stay memoised on it, as the
logical-id locator does on the host.

Both searches are host-synchronising: they read the selected ids on the
host to find their rows.  Logical ids are assigned at insert and stay
stable across compactions; results carry logical ids (int32).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.backends import (_batch_rows, _device, _empty_topk, _reference_tail,
                                       _rows, resolve_backend)
from repro_torch.core.brute_force import TopK, concat_topk, merge_topk
from repro_torch.core.spaces import map_tensors, tensor_leaves

__all__ = [
    "SegmentSnapshot",
    "compact",
    "concat_rows",
    "frozen_topk",
    "live_topk",
    "materialize",
    "take_rows",
]


def _empty_ids() -> np.ndarray:
    return np.zeros(0, dtype=np.int64)


def _empty_mask() -> np.ndarray:
    return np.zeros(0, dtype=bool)


def _corpus_device(corpus) -> torch.device:
    return tensor_leaves(corpus)[0].device


def take_rows(corpus, idx):
    """Gather rows ``idx`` (numpy or tensor) from a row-major corpus
    (None stays None)."""
    if corpus is None:
        return None
    take = torch.as_tensor(idx, dtype=torch.long, device=_corpus_device(corpus))
    return map_tensors(lambda leaf: leaf[take], corpus)


def _map_pairs(fn, a, b):
    """``fn`` on the paired tensor leaves of two corpora of one structure."""
    if a is None or b is None:
        if a is not None or b is not None:
            raise ValueError("corpora differ in structure")
        return None
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return type(a)(*(_map_pairs(fn, x, y) for x, y in zip(a, b)))


def concat_rows(a, b):
    """Row-concatenate two corpora of the same structure."""
    if a is None:
        return b
    if b is None:
        return a
    return _map_pairs(lambda x, y: torch.cat([x, y], dim=0), a, b)


def _gather_rows(parts):
    """Rows ``idx`` of each ``(corpus, idx)`` part, in order, gathered leaf
    by leaf into one preallocated output: a pure copy, so the bits equal
    a gather-then-concatenate, at the output's size and no more."""
    first = parts[0][0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        total = sum(len(idx) for _, idx in parts)
        out = torch.empty((total, *first.shape[1:]), dtype=first.dtype, device=first.device)
        at = 0
        for leaf, idx in parts:
            torch.index_select(leaf, 0, idx, out=out[at:at + len(idx)])
            at += len(idx)
        return out
    return type(first)(*(_gather_rows([(corpus[i], idx) for corpus, idx in parts])
                         for i in range(len(first))))


def _frozen_np(arr, dtype) -> np.ndarray:
    out = np.array(arr, dtype=dtype)
    out.flags.writeable = False
    return out


@dataclasses.dataclass(frozen=True)
class SegmentSnapshot:
    """One immutable logical state of a live corpus.

    ``main`` / ``append`` are row-major corpora (or None when empty);
    ``*_ids`` map physical rows to stable logical ids; ``*_dead`` flag
    tombstoned physical rows (deleted, or superseded by an upsert).
    ``generation`` rises by exactly one per mutation batch and per
    compaction; it is the value framed into serving cache keys."""

    generation: int = 0
    main: Any = None
    main_ids: np.ndarray = dataclasses.field(default_factory=_empty_ids)
    main_dead: np.ndarray = dataclasses.field(default_factory=_empty_mask)
    append: Any = None
    append_ids: np.ndarray = dataclasses.field(default_factory=_empty_ids)
    append_dead: np.ndarray = dataclasses.field(default_factory=_empty_mask)

    def __post_init__(self):
        object.__setattr__(self, "main_ids", _frozen_np(self.main_ids, np.int64))
        object.__setattr__(self, "main_dead", _frozen_np(self.main_dead, bool))
        object.__setattr__(self, "append_ids", _frozen_np(self.append_ids, np.int64))
        object.__setattr__(self, "append_dead", _frozen_np(self.append_dead, bool))
        for seg, ids, dead, label in (
                (self.main, self.main_ids, self.main_dead, "main"),
                (self.append, self.append_ids, self.append_dead, "append")):
            n = _rows(seg) if seg is not None else 0
            if n is None:
                raise ValueError(f"{label} segment is not row-major")
            if len(ids) != n or len(dead) != n:
                raise ValueError(
                    f"{label} segment has {n} rows but {len(ids)} ids / "
                    f"{len(dead)} dead flags")

    @property
    def n_main(self) -> int:
        return len(self.main_ids)

    @property
    def n_append(self) -> int:
        return len(self.append_ids)

    @property
    def n_dead(self) -> int:
        """Tombstone count: physical rows still resident but not live."""
        return int(self.main_dead.sum()) + int(self.append_dead.sum())

    @property
    def n_live(self) -> int:
        return self.n_main + self.n_append - self.n_dead

    def live_ids(self) -> np.ndarray:
        """Logical ids of live rows, in storage (materialization) order."""
        return np.concatenate([self.main_ids[~self.main_dead],
                               self.append_ids[~self.append_dead]])


def materialize(snap: SegmentSnapshot):
    """Collapse a snapshot to ``(corpus, ids)``: live rows only, in
    storage order (live main rows, then live append rows), each leaf
    gathered once into its output.  Storage order is what compaction
    freezes into the next main segment.  ``(None, empty)`` for an empty
    logical state."""
    parts, ids = [], []
    for seg, seg_ids, dead in ((snap.main, snap.main_ids, snap.main_dead),
                               (snap.append, snap.append_ids, snap.append_dead)):
        keep = np.nonzero(~dead)[0]
        if len(keep):
            parts.append((seg, torch.from_numpy(keep).to(_corpus_device(seg))))
            ids.append(seg_ids[keep])
    if not parts:
        return None, _empty_ids()
    return _gather_rows(parts), np.concatenate(ids)


def compact(snap: SegmentSnapshot) -> SegmentSnapshot:
    """main + append - tombstones -> a new single-segment snapshot with no
    tombstones and ``generation + 1``.  Compaction commutes with
    querying: for exact backends ``live_topk`` answers the same bits on
    either side of it."""
    corpus, ids = materialize(snap)
    return SegmentSnapshot(generation=snap.generation + 1, main=corpus, main_ids=ids,
                           main_dead=np.zeros(len(ids), dtype=bool))


def _pair_scores(space, queries, docs_flat, b: int, k: int) -> torch.Tensor:
    """Canonical rescoring: ``b * k`` (query, doc) pairs through
    ``space.score_pairs``, folded back to ``(b, k)``.  The same ``(b, k)``
    and the same row bits give the same score bits."""
    q_rep = map_tensors(lambda x: x.repeat_interleave(k, dim=0), queries)
    return space.score_pairs(q_rep, docs_flat).reshape(b, k)


def _locator(snap: SegmentSnapshot):
    """Sorted logical id -> (physical row, in append) over live rows, built
    once per (immutable) snapshot and memoised on it."""
    cache = getattr(snap, "_locator_cache", None)
    if cache is None:
        main_live, app_live = ~snap.main_dead, ~snap.append_dead
        ids = np.concatenate([snap.main_ids[main_live], snap.append_ids[app_live]])
        pos = np.concatenate([np.nonzero(main_live)[0], np.nonzero(app_live)[0]])
        in_app = np.concatenate([np.zeros(int(main_live.sum()), dtype=bool),
                                 np.ones(int(app_live.sum()), dtype=bool)])
        order = np.argsort(ids, kind="stable")
        cache = (ids[order], pos[order], in_app[order])
        object.__setattr__(snap, "_locator_cache", cache)
    return cache


def _segment_state(snap: SegmentSnapshot, which: str, device):
    """A segment's logical ids (i32) and tombstone flags on ``device``
    and its tombstone count, moved once per snapshot and memoised on it.
    On the card the memo is made on its first reader's stream and read on
    others: each read marks it used by the current stream, so that it is
    not reused while reads queued there are pending."""
    cache = getattr(snap, "_segment_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(snap, "_segment_cache", cache)
    key = (which, str(device))
    if key not in cache:
        ids = getattr(snap, f"{which}_ids")
        dead = getattr(snap, f"{which}_dead")
        cache[key] = (torch.from_numpy(ids.astype(np.int32)).to(device),
                      torch.from_numpy(dead.copy()).to(device), int(dead.sum()))
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for t in cache[key][:2]:
            t.record_stream(stream)
    return cache[key]


def _select_rows(sel: np.ndarray, app_rows, main_rows):
    """Per-row choice between two gathered row sets (a pure copy, so the
    chosen bits equal a gather from one corpus)."""
    if main_rows is None:
        return app_rows
    if app_rows is None:
        return main_rows

    def pick(a, m):
        flags = torch.from_numpy(sel).to(a.device)
        return torch.where(flags.reshape((-1,) + (1,) * (a.dim() - 1)), a, m)

    return _map_pairs(pick, app_rows, main_rows)


def _rescore_live(space, snap: SegmentSnapshot, queries, head: TopK) -> TopK:
    """Replace a merged head's scan scores with the canonical pair
    rescoring of its (live) rows, keeping the selection's order."""
    b, hk = head.indices.shape
    want = head.indices.cpu().numpy().astype(np.int64).ravel()
    ids, pos, in_app = _locator(snap)
    j = np.searchsorted(ids, want)
    app = in_app[j]
    p = pos[j]
    main_rows = take_rows(snap.main, np.where(app, 0, p)) if snap.n_main else None
    app_rows = take_rows(snap.append, np.where(app, p, 0)) if snap.n_append else None
    docs = _select_rows(app, app_rows, main_rows)
    return TopK(_pair_scores(space, queries, docs, b, hk), head.indices)


def _clamped(indices: torch.Tensor, n: int) -> torch.Tensor:
    """Row ids clamped to [0, n): an ANN fetch that found fewer rows pads
    with tail ids (n, n + 1, ..., scoring -inf), which gather as repro's
    clamped gathers do instead of indexing past the segment."""
    return indices.long().clamp(0, n - 1)


def _segment_topk(space, snap: SegmentSnapshot, which: str, queries, k, backend) -> TopK:
    """Candidates from one segment: fetch ``k + dead rows`` physical rows
    through the backend (which picks its kernel for that depth), mask
    tombstones to -inf, map rows to logical ids.  The over-fetch leaves
    at least ``min(k, live rows)`` live candidates, in the backend's
    (score descending, lower row first) order, which the mask keeps."""
    seg = getattr(snap, which)
    n = len(getattr(snap, f"{which}_ids"))
    ids_dev, dead_dev, n_dead = _segment_state(snap, which, _corpus_device(seg))
    k_fetch = min(n, k + n_dead)
    res = resolve_backend(backend, space, seg).topk(space, queries, seg, k_fetch, n_valid=n)
    rows = _clamped(res.indices, n)
    scores = torch.where(dead_dev[rows], torch.full_like(res.scores, -torch.inf), res.scores)
    return TopK(scores, ids_dev[rows])


def live_topk(space, snap: SegmentSnapshot, queries, k: int, *,
              main_backend="reference", append_backend="reference") -> TopK:
    """Top-k over a snapshot's logical state, in logical ids.

    The main segment goes through ``main_backend`` (any registered
    backend, exact or ANN), the append segment through ``append_backend``
    (exact).  The main fetch depth is ``k + main tombstones``: an ANN
    budget (``ef``, ``rerank_qty``) must cover it, which the serving
    wrapper bounds through its compaction thresholds."""
    b = _batch_rows(queries)
    dev = _device(queries)
    if k <= 0:
        return _empty_topk(b, dev)
    parts = []
    if snap.n_main:
        parts.append(_segment_topk(space, snap, "main", queries, k, main_backend))
    if snap.n_append:
        parts.append(_segment_topk(space, snap, "append", queries, k, append_backend))
    n_live = snap.n_live
    hk = min(k, n_live)
    if not parts or hk == 0:
        return _reference_tail(_empty_topk(b, dev), b, k, 0)
    merged = _rescore_live(space, snap, queries, merge_topk(concat_topk(parts), hk))
    return merged if hk == k else _reference_tail(merged, b, k, n_live)


def frozen_topk(space, corpus, ids: np.ndarray, queries, k: int,
                backend="reference") -> TopK:
    """The oracle of frozen equivalence: search a materialized corpus
    (``materialize``'s output) and answer in logical ids, with the same
    rescoring and degenerate tail as :func:`live_topk`."""
    b = _batch_rows(queries)
    dev = _device(queries)
    n = len(ids)
    if k <= 0:
        return _empty_topk(b, dev)
    if n == 0:
        return _reference_tail(_empty_topk(b, dev), b, k, 0)
    hk = min(k, n)
    res = resolve_backend(backend, space, corpus).topk(space, queries, corpus, hk, n_valid=n)
    rows = _clamped(res.indices, n)
    docs = take_rows(corpus, rows.reshape(-1))
    logical = torch.from_numpy(np.asarray(ids).astype(np.int32)).to(rows.device)
    head = TopK(_pair_scores(space, queries, docs, b, hk), logical[rows])
    return head if hk == k else _reference_tail(head, b, k, n)
