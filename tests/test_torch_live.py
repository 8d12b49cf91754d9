"""repro_torch.serving.{live,cache} and ``pipeline.pin_snapshot``: the
``LiveCorpus`` unit cases of ``tests/test_live.py`` run against the port,
snapshot consistency under a writer thread and the background compactor,
the snapshot seam of ``RetrievalPipeline``, and ``QueryCache`` keys
(generation framing, -0 normalisation, digests equal to repro's for f32
queries).  Results are held to the port's frozen oracle bit for bit
(ids and score bits), and to repro's live answer with ids equal and
scores within ``F32_RTOL``.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import LiveCorpus as JLive
from repro.serving import quantized_key as j_quantized_key
from repro.core.spaces import DenseSpace as JDense
from repro_torch.core import segments
from repro_torch.core.pipeline import BruteForceGenerator, RetrievalPipeline, pin_snapshot
from repro_torch.core.sparse import SparseVectors
from repro_torch.core.spaces import DenseSpace, FusedVectors
from repro_torch.serving import (LiveCorpus, LiveGenerator, QueryCache, SnapshotGenerator,
                                 quantized_key)

from _mutation import random_schedule
from _torch_parity import (apply_schedule_torch, assert_topk_match, assert_torch_topk_equal,
                           np_of)

pytestmark = pytest.mark.torch

N0, D, B, K = 48, 16, 4, 10


def _space():
    return DenseSpace("ip")


def _base(seed=0, n=N0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)))


def _fresh(corpus=None, space=None, **kw):
    kw.setdefault("max_append", 10 ** 9)      # no compaction unless a test asks
    return LiveCorpus(space or _space(), corpus, device="cpu", **kw)


def _frozen(live, queries, k):
    snap = live.snapshot()
    return segments.frozen_topk(live.space, *segments.materialize(snap), queries, k)


def _assert_live_equals_frozen(live, queries, k, ctx=""):
    got = live.topk(queries, k)
    assert_torch_topk_equal(got, _frozen(live, queries, k), ctx)
    return got


class TestLiveCorpusUnits:

    def test_empty_corpus_serves_reference_tail(self):
        _, queries = _base()
        got = _fresh().topk(queries, 3)
        assert bool((got.scores == -torch.inf).all())
        assert torch.equal(got.indices, torch.tensor([0, 1, 2], dtype=torch.int32).expand(B, 3))

    def test_insert_into_empty_assigns_sequential_ids(self):
        _, queries = _base()
        live = _fresh()
        assert live.insert(torch.ones(3, D)).tolist() == [0, 1, 2]
        assert live.corpus_dtype == "float32"
        _assert_live_equals_frozen(live, queries, 5)

    def test_deleted_ids_are_never_reused(self):
        corpus, _ = _base()
        live = _fresh(corpus)
        live.delete([N0 - 1])
        assert live.insert(torch.ones(1, D)).tolist() == [N0]

    def test_delete_unknown_id_raises_and_leaves_state_unchanged(self):
        corpus, queries = _base()
        live = _fresh(corpus)
        before = live.topk(queries, K)
        for bad in ([5, 999], [7, 7], [-1]):
            with pytest.raises(KeyError):
                live.delete(bad)
        assert live.generation == 0 and live.snapshot().n_dead == 0
        live.delete([5, 7])        # the failed calls changed nothing: both still live
        assert live.snapshot().n_dead == 2
        assert not torch.equal(live.topk(queries, N0).indices, before.indices)

    def test_upsert_inserts_unknown_ids_under_stable_ids(self):
        corpus, queries = _base()
        live = _fresh(corpus)
        live.upsert(np.array([N0 + 7]), torch.ones(1, D))
        assert N0 + 7 in set(live.snapshot().live_ids().tolist())
        assert live.insert(torch.zeros(1, D)).tolist() == [N0 + 8]
        _assert_live_equals_frozen(live, queries, K)

    def test_upsert_of_an_unseen_id_below_the_largest(self):
        """Ids given at construction may leave gaps; an upsert can fill one."""
        corpus, queries = _base()
        live = _fresh(corpus, ids=np.arange(N0) * 3)
        live.upsert(np.array([4, 4, 7]), torch.arange(3 * D, dtype=torch.float32).reshape(3, D))
        live.delete([3, 7])
        assert set(live.snapshot().live_ids().tolist()) == set((np.arange(N0) * 3).tolist()) - {3} | {4}
        assert live.insert(torch.ones(1, D)).tolist() == [3 * (N0 - 1) + 1]
        _assert_live_equals_frozen(live, queries, N0 + 5)
        live.compact()
        _assert_live_equals_frozen(live, queries, N0 + 5)

    def test_upsert_same_id_twice_in_one_batch_last_wins(self):
        live = _fresh(torch.zeros(2, D), space=DenseSpace("l2"))
        a, b = np.ones(D, np.float32), np.full(D, 2.0, np.float32)
        live.upsert(np.array([0, 0]), np.stack([a, b]))
        assert live.snapshot().n_live == 2
        got = live.topk(torch.from_numpy(b)[None], 1)
        assert int(got.indices[0, 0]) == 0 and float(got.scores[0, 0]) == 0.0

    def test_generation_increments_once_per_batch(self):
        corpus, _ = _base()
        live = _fresh(corpus)
        assert live.generation == 0
        live.insert(torch.ones(3, D))
        assert live.generation == 1
        live.delete([0, 1])
        assert live.generation == 2
        live.upsert(np.array([2]), torch.ones(1, D))
        assert live.generation == 3
        assert live.compact() and live.generation == 4
        assert not live.compact() and live.generation == 4

    def test_snapshot_arrays_are_frozen(self):
        corpus, _ = _base()
        snap = _fresh(corpus).snapshot()
        with pytest.raises(ValueError):
            snap.main_dead[0] = True
        with pytest.raises(ValueError):
            snap.main_ids[0] = 99

    def test_snapshot_validates_row_counts(self):
        corpus, _ = _base()
        with pytest.raises(ValueError):
            segments.SegmentSnapshot(main=corpus, main_ids=np.arange(3, dtype=np.int64),
                                     main_dead=np.zeros(3, bool))

    def test_init_rejects_duplicate_or_mismatched_ids(self):
        corpus, _ = _base()
        with pytest.raises(ValueError):
            _fresh(corpus, ids=np.zeros(N0, dtype=np.int64))
        with pytest.raises(ValueError):
            _fresh(corpus, ids=np.arange(N0 - 1))

    def test_append_backend_must_be_exact(self):
        corpus, _ = _base()
        for bad in ("graph_ann", "napp"):
            with pytest.raises(ValueError):
                _fresh(corpus, append_backend=bad)
        for good in ("reference", "streaming", "cuda", "pallas"):
            _fresh(corpus, append_backend=good)

    def test_threshold_triggers_inline_compaction(self):
        corpus, queries = _base()
        live = _fresh(corpus, max_append=4)
        for _ in range(4):
            live.insert(torch.ones(1, D))
        snap = live.snapshot()
        assert snap.n_append == 0 and snap.n_main == N0 + 4
        assert live.live_stats()["compactions"] == 1
        _assert_live_equals_frozen(live, queries, K)

    def test_max_dead_threshold_triggers_compaction(self):
        corpus, _ = _base()
        live = _fresh(corpus, max_dead=3)
        live.delete([0, 1, 2])
        assert live.snapshot().n_dead == 0 and live.snapshot().n_main == N0 - 3

    def test_live_stats_shape(self):
        corpus, _ = _base()
        live = _fresh(corpus)
        live.insert(torch.ones(2, D))
        live.delete([0])
        s = live.live_stats()
        assert s["generation"] == 2
        assert s["segment_rows"] == {"main": N0, "append": 2}
        assert s["tombstones"] == 1
        assert s["snapshot_age_s"] >= 0.0
        assert s["compactions"] == 0 and s["compaction_s"] == []

    def test_numpy_rows_go_to_the_corpus_device_and_dtype(self):
        corpus, queries = _base()
        live = _fresh(corpus, corpus_dtype="bf16")
        assert live.snapshot().main.dtype == torch.bfloat16
        live.insert(np.ones((2, D), np.float32))
        app = live.snapshot().append
        assert app.device.type == "cpu" and app.dtype == torch.bfloat16
        assert live.corpus_dtype == "bfloat16"
        fused = _fresh(FusedVectors(corpus, SparseVectors(torch.zeros(N0, 2, dtype=torch.int32),
                                                          torch.ones(N0, 2))))
        fused.insert(FusedVectors(np.zeros((1, D), np.float32),
                                  SparseVectors(np.zeros((1, 2), np.int32), np.ones((1, 2), np.float32))))
        assert isinstance(fused.snapshot().append, FusedVectors)
        assert fused.snapshot().append.sparse.indices.dtype == torch.int32

    def test_the_card_is_the_default_and_there_is_no_fallback(self, monkeypatch):
        """``device=None`` means the CUDA card: without one, a live corpus
        over CPU tensors raises instead of scanning on the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        corpus, _ = _base()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LiveCorpus(_space(), corpus, backend="cuda", append_backend="cuda")
        with pytest.raises(RuntimeError):
            LiveCorpus(_space())


@pytest.mark.parametrize("seed", range(4))
def test_schedule_answers_as_repro_and_as_frozen(seed):
    corpus, queries = _base(seed)
    jl = JLive(JDense("ip"), jnp.asarray(corpus.numpy()), max_append=10 ** 9)
    tl = _fresh(corpus, backend="cuda", append_backend="streaming")
    ops_ = random_schedule(seed, 16, D, N0)
    for op in ops_:
        if op[0] == "insert":
            jl.insert(jnp.asarray(op[1]))
        elif op[0] == "delete":
            jl.delete(op[1])
        else:
            jl.upsert(op[1], jnp.asarray(op[2]))
    apply_schedule_torch(tl, ops_)
    for label in ("pre", "post"):
        got = _assert_live_equals_frozen(tl, queries, K, label)
        want = jl.topk(jnp.asarray(queries.numpy()), K)
        assert_topk_match((np.asarray(want.scores), np.asarray(want.indices)), (np_of(got.scores),
                                                                                 np_of(got.indices)))
        assert tl.live_stats()["tombstones"] == jl.live_stats()["tombstones"]
        jl.compact()
        tl.compact()


class _RecordingLive(LiveCorpus):
    """Records every swapped-in snapshot by generation (the swap happens
    under the writer lock, so the record is complete)."""

    def __init__(self, *a, **kw):
        self.history = {}
        super().__init__(*a, **kw)
        self.history[self._snapshot.generation] = self._snapshot

    def _swap(self, snap):
        self.history[snap.generation] = snap
        super()._swap(snap)


class TestSnapshotConsistency:

    def test_reader_only_ever_sees_recorded_post_batch_states(self):
        corpus, queries = _base()
        live = _RecordingLive(_space(), corpus, max_append=10 ** 9, device="cpu")
        stop = threading.Event()
        failures = []

        def reader():
            while not stop.is_set():
                snap = live.snapshot()
                if snap is not live.history.get(snap.generation):
                    failures.append(snap.generation)
                res = segments.live_topk(live.space, snap, queries, K)
                if res.indices.shape != (B, K):
                    failures.append(("shape", snap.generation))

        threads = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            apply_schedule_torch(live, random_schedule(3, 40, D, N0))
            live.compact()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not failures
        assert sorted(live.history) == list(range(live.generation + 1))

    def test_bound_snapshot_pins_through_mutations(self):
        corpus, queries = _base()
        live = _fresh(corpus)
        gen = LiveGenerator(live)
        bound = gen.bind_snapshot()
        assert isinstance(bound, SnapshotGenerator) and gen.last_served_generation == 0
        want_old = _frozen(live, queries, K)
        live.delete(list(range(8)))
        live.insert(torch.ones(4, D))
        assert_torch_topk_equal(bound.generate(queries, K), want_old, "pinned snapshot")
        rebound = gen.bind_snapshot()
        assert gen.last_served_generation == 2
        assert_torch_topk_equal(rebound.generate(queries, K), _frozen(live, queries, K), "rebound")

    def test_background_compactor_races_writers_and_readers(self):
        """Writers, two readers and the background compactor at once (the
        interpreter switching threads every 10 us): every read equals the
        frozen oracle of the snapshot it pinned, and the final state, after
        close(), equals a fresh corpus at the same logical state."""
        corpus, queries = _base(8)
        live = _fresh(corpus, backend="cuda", append_backend="cuda", max_append=6, max_dead=5,
                      compact_interval_s=0.01)
        failures = []
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                snap = live.snapshot()
                got = segments.live_topk(live.space, snap, queries, K, main_backend="cuda",
                                         append_backend="cuda")
                want = segments.frozen_topk(live.space, *segments.materialize(snap), queries, K)
                if not (torch.equal(got.indices, want.indices) and torch.equal(got.scores, want.scores)):
                    failures.append(snap.generation)

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=reader) for _ in range(2)]
        try:
            live.start()
            for t in threads:
                t.start()
            apply_schedule_torch(live, random_schedule(12, 60, D, N0, min_live=K))
            deadline = time.monotonic() + 60
            while live.snapshot().n_append >= 6 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
            live.close()
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        assert not failures, failures
        assert live.live_stats()["compactions"] >= 1
        _assert_live_equals_frozen(live, queries, K, "after close")
        gens = live.generation
        assert live.compact() in (True, False) and live.generation >= gens


def test_pipeline_pins_the_snapshot_once_per_batch():
    corpus, queries = _base()
    live = _fresh(corpus)
    gen = LiveGenerator(live)
    pipe = RetrievalPipeline(gen, cand_qty=K, final_qty=3)
    live.delete([0, 1])
    got = pipe.run(queries)
    assert gen.last_served_generation == live.generation == 1
    want = _frozen(live, queries, K)
    assert_torch_topk_equal(got, type(got)(want.scores[:, :3], want.indices[:, :3]))
    frozen = BruteForceGenerator(_space(), corpus)
    assert pin_snapshot(frozen) is frozen
    assert isinstance(pin_snapshot(gen), SnapshotGenerator)


class TestQueryCache:

    def test_generation_is_framed_apart_from_none_and_zero(self):
        q = torch.ones(1, 4)
        keys = {quantized_key("ep", q, generation=g) for g in (None, 0, 1, 2)}
        assert len(keys) == 4
        assert quantized_key("ep", q, generation=3) == quantized_key("ep", q.clone(), generation=3)

    def test_fields_are_length_framed(self):
        q = torch.ones(1, 4)
        assert (quantized_key("ab", q, backend="c") != quantized_key("a", q, backend="bc"))
        assert (quantized_key("e", q, backend="cuda", corpus_dtype="float32")
                != quantized_key("e", q, backend="cuda", corpus_dtype="bfloat16"))
        assert quantized_key("e", q, profile="p1") != quantized_key("e", q, profile="p2")

    def test_negative_zero_and_jitter_quantize_alike(self):
        a = torch.tensor([[0.0, 1.0, 2.5]])
        b = torch.tensor([[-0.0, 1.0 + 1e-9, 2.5]])
        assert quantized_key("e", a) == quantized_key("e", b)
        assert quantized_key("e", a) != quantized_key("e", a.reshape(3, 1))
        assert quantized_key("e", a.bfloat16()) == quantized_key("e", a)

    def test_digest_equals_repros_for_f32_and_int_queries(self):
        rng = np.random.default_rng(0)
        dense = rng.standard_normal((2, 5)).astype(np.float32)
        idx = rng.integers(0, 50, (2, 3)).astype(np.int32)
        val = rng.standard_normal((2, 3)).astype(np.float32)
        from repro.core.sparse import SparseVectors as JSV
        from repro.core.spaces import FusedVectors as JFV
        jq = JFV(jnp.asarray(dense), JSV(jnp.asarray(idx), jnp.asarray(val)))
        tq = FusedVectors(torch.from_numpy(dense), SparseVectors(torch.from_numpy(idx), torch.from_numpy(val)))
        for kw in ({}, {"generation": 0}, {"generation": 5, "backend": "cuda", "corpus_dtype": "float32"}):
            assert quantized_key("fused", tq, **kw) == j_quantized_key("fused", jq, **kw)

    def test_lru_and_frozen_values(self):
        cache = QueryCache(capacity=2)
        keys = [cache.key("e", torch.full((1, 2), float(i)), generation=1) for i in range(3)]
        for i, k in enumerate(keys):
            cache.put(k, (np.arange(3) + i, {"ids": np.zeros(2)}))
        assert len(cache) == 2 and cache.get(keys[0]) is None
        value = cache.get(keys[2])
        with pytest.raises(ValueError):
            value[0][0] = 7
        with pytest.raises(ValueError):
            value[1]["ids"][0] = 7
        with pytest.raises(ValueError):
            QueryCache(capacity=0)


def test_serving_and_segments_import_no_jax():
    import os
    import subprocess
    from pathlib import Path

    code = ("import sys, repro_torch.serving, repro_torch.core.segments, repro_torch.core.fusion; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
