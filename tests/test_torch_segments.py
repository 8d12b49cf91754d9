"""repro_torch.core.segments and ``score_pairs`` held against repro, and
the frozen-equivalence contract inside the port.

The same random insert / delete / upsert / compact schedules
(``tests/_mutation.py``) drive repro's ``LiveCorpus`` and the port's:
ids equal, scores within ``F32_RTOL`` (2e-6) of the row's largest
|score|, -inf tails equal.  Inside the port, ``live_topk`` must equal
``frozen_topk`` over the materialized corpus bit for bit (ids and score
bits) for every pair of exact backends (reference, streaming, and cuda,
whose plain versions run on the CPU), and a fetch of ``k + tombstones``
past the scan kernels' 2048 rows must go through ``ops.topk_large``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segments as jseg
from repro.core import sparse as jsp
from repro.core.spaces import DenseSpace as JDense
from repro.core.spaces import FusedSpace as JFused
from repro.core.spaces import FusedVectors as JFV
from repro.core.spaces import SparseSpace as JSparse
from repro.serving import LiveCorpus as JLive
from repro_torch.core import segments as tseg
from repro_torch.core import sparse as tsp
from repro_torch.core.brute_force import TopK
from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors, SparseSpace
from repro_torch.kernels import ops
from repro_torch.kernels.mips_topk import MAX_K
from repro_torch.serving import LiveCorpus

from _mutation import random_schedule, simulate_live_ids
from _torch_parity import (apply_schedule_torch, assert_scores_close, assert_topk_match,
                           assert_torch_topk_equal, np_of)

pytestmark = pytest.mark.torch

N0, D, B, K = 48, 16, 4, 10
V, NNZ = 40, 5
EXACT = ("reference", "streaming", "cuda")


def _rows_np(kind, rows):
    """numpy rows of a schedule (m, D) -> the kind's numpy parts: dense
    rows as they are; sparse ids and values derived from them."""
    rows = np.asarray(rows, np.float32)
    idx = (np.abs(rows[:, :NNZ]) * 997).astype(np.int32) % (V + 1)    # id V: padding
    val = np.abs(rows[:, NNZ:2 * NNZ]).astype(np.float32)
    return rows, idx, val


def _case(kind):
    """(repro space, port space, numpy rows -> repro rows, -> port rows)."""
    def jrows(rows):
        d, i, v = _rows_np(kind, rows)
        if kind.startswith("dense"):
            return jnp.asarray(d)
        s = jsp.SparseVectors(jnp.asarray(i), jnp.asarray(v))
        return s if kind == "sparse" else JFV(jnp.asarray(d), s)

    def trows(rows):
        d, i, v = _rows_np(kind, rows)
        if kind.startswith("dense"):
            return d
        s = tsp.SparseVectors(i, v)
        return s if kind == "sparse" else FusedVectors(d, s)

    spaces = {"dense_ip": (JDense("ip"), DenseSpace("ip")), "dense_l2": (JDense("l2"), DenseSpace("l2")),
              "dense_cosine": (JDense("cosine"), DenseSpace("cosine")),
              "sparse": (JSparse(V), SparseSpace(V)),
              "fused": (JFused(V, 0.7, 1.3), FusedSpace(V, 0.7, 1.3))}
    return (*spaces[kind], jrows, trows)


def _torch_queries(kind, q):
    d, i, v = _rows_np(kind, q)
    t = lambda a: torch.from_numpy(a)
    if kind.startswith("dense"):
        return t(d)
    s = tsp.SparseVectors(t(i), t(v))
    return s if kind == "sparse" else FusedVectors(t(d), s)


def _apply_jax(live, ops_, jrows):
    """``tests/_mutation.apply_schedule`` for repro, the rows mapped to the kind."""
    for op in ops_:
        if op[0] == "insert":
            live.insert(jrows(op[1]))
        elif op[0] == "delete":
            live.delete(op[1])
        else:
            live.upsert(op[1], jrows(op[2]))


def _base(seed=0, n=N0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _port_live(tspace, corpus, backend="reference", append_backend="reference", **kw):
    kw.setdefault("max_append", 10 ** 9)
    return LiveCorpus(tspace, corpus, backend=backend, append_backend=append_backend,
                      device="cpu", **kw)


def _np_topk(res):
    return np_of(res.scores), np_of(res.indices)


@pytest.mark.parametrize("port_backend", EXACT)
@pytest.mark.parametrize("kind", ["dense_ip", "dense_l2", "dense_cosine", "sparse", "fused"])
def test_schedules_match_repro(kind, port_backend):
    jspace, tspace, jrows, trows = _case(kind)
    for seed in range(2):
        corpus, q = _base(seed)
        jl = JLive(jspace, jrows(corpus), max_append=10 ** 9)
        tl = _port_live(tspace, trows(corpus), port_backend, port_backend)
        ops_ = random_schedule(seed, 12, D, N0)
        _apply_jax(jl, ops_, jrows)
        apply_schedule_torch(tl, ops_, trows)
        jq, tq = jrows(q), _torch_queries(kind, q)
        for label in ("pre", "post"):
            for k in (K, tl.snapshot().n_live + 3):
                assert_topk_match(_np_topk(jl.topk(jq, k)), _np_topk(tl.topk(tq, k)),
                                  ctx=f"{kind} seed {seed} {label} k={k}")
            assert jl.generation == tl.generation
            jl.compact()
            tl.compact()


@pytest.mark.parametrize("append_backend", EXACT)
@pytest.mark.parametrize("main_backend", EXACT)
def test_live_equals_frozen_bitwise_for_every_exact_pair(main_backend, append_backend):
    for kind in ("dense_ip", "fused"):
        _, tspace, _, trows = _case(kind)
        corpus, q = _base(3)
        live = _port_live(tspace, trows(corpus), main_backend, append_backend)
        apply_schedule_torch(live, random_schedule(5, 14, D, N0), trows)
        tq = _torch_queries(kind, q)
        for label in ("pre", "post"):
            snap = live.snapshot()
            want = tseg.frozen_topk(tspace, *tseg.materialize(snap), tq, K)
            assert_torch_topk_equal(live.topk(tq, K), want, ctx=f"{kind} {label}")
            live.compact()


@pytest.mark.parametrize("seed", range(4))
def test_tombstoned_ids_never_surface_and_the_tail(seed):
    _, tspace, _, trows = _case("dense_ip")
    corpus, q = _base(seed)
    live = _port_live(tspace, trows(corpus))
    ops_ = random_schedule(seed, 10, D, N0, kinds=("delete", "delete", "upsert", "insert"))
    apply_schedule_torch(live, ops_, trows)
    expected = simulate_live_ids(N0, ops_)
    assert set(live.snapshot().live_ids().tolist()) == expected
    n_live = len(expected)
    for label in ("pre", "post"):
        got = live.topk(torch.from_numpy(q), n_live + 5)
        fin = torch.isfinite(got.scores)
        for row in range(B):
            assert set(got.indices[row][fin[row]].tolist()) == expected, label
        tail = got.indices[~fin].reshape(B, -1)
        assert torch.equal(tail, torch.arange(n_live, n_live + 5, dtype=torch.int32).expand(B, 5))
        live.compact()


def test_empty_states_and_k_zero():
    _, tspace, _, _ = _case("dense_ip")
    q = torch.from_numpy(_base()[1])
    live = _port_live(tspace, None)
    got = live.topk(q, 3)
    assert torch.equal(got.indices, torch.arange(3, dtype=torch.int32).expand(B, 3))
    assert bool((got.scores == -torch.inf).all())
    assert live.topk(q, 0).scores.shape == (B, 0)
    corpus, ids = tseg.materialize(live.snapshot())
    assert corpus is None and len(ids) == 0
    assert tseg.frozen_topk(tspace, corpus, ids, q, 0).indices.shape == (B, 0)


def test_fetch_past_max_k_goes_through_topk_large(monkeypatch):
    """k + main tombstones > MAX_K: the cuda backend's large-k path serves
    the main fetch (counted by a wrapper around ``ops.topk_large``, since
    the kernels' own ``launches`` counters count card launches only); the
    answer equals the frozen oracle bit for bit and repro's live answer."""
    n, k, dead = MAX_K + 150, 10, MAX_K + 100
    rng = np.random.default_rng(11)
    corpus = rng.standard_normal((n, 8)).astype(np.float32)
    q = rng.standard_normal((B, 8)).astype(np.float32)
    calls = []
    real = ops.topk_large

    def counting(*a, **kw):
        calls.append(a[5])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "topk_large", counting)
    live = _port_live(DenseSpace("ip"), corpus, "cuda", "cuda")
    jl = JLive(JDense("ip"), jnp.asarray(corpus), max_append=10 ** 9)
    gone = rng.permutation(n)[:dead]
    for lv in (live, jl):
        lv.delete(gone)
    extra = rng.standard_normal((3, 8)).astype(np.float32)
    live.insert(extra)
    jl.insert(jnp.asarray(extra))
    got = live.topk(torch.from_numpy(q), k)
    assert calls == [k + dead], calls
    want = tseg.frozen_topk(DenseSpace("ip"), *tseg.materialize(live.snapshot()), torch.from_numpy(q), k)
    assert_torch_topk_equal(got, want)
    assert_topk_match(_np_topk(jl.topk(jnp.asarray(q), k)), _np_topk(got))


def _score_pair_cases():
    rng = np.random.default_rng(3)
    m, d = 7, 6
    qd = rng.standard_normal((m, d)).astype(np.float32)
    dd = rng.standard_normal((m, d)).astype(np.float32)
    qi = rng.integers(0, V + 1, (m, 4)).astype(np.int32)
    di = rng.integers(0, V + 1, (m, 5)).astype(np.int32)
    di[:, 0] = qi[:, 0]
    qv = rng.uniform(-1, 1, (m, 4)).astype(np.float32)
    dv = rng.uniform(-1, 1, (m, 5)).astype(np.float32)
    cases = []
    for kind in ("ip", "cosine", "l2", "lp"):
        for dt in ("float32", "bfloat16"):
            cases.append((f"dense {kind} {dt}", JDense(kind, 3.0), DenseSpace(kind, 3.0),
                          ("d", qd, dd, dt)))
    for kind in ("ip", "cosine"):
        for dt in ("float32", "bfloat16"):
            cases.append((f"sparse {kind} {dt}", JSparse(V, kind), SparseSpace(V, kind),
                          ("s", (qi, qv), (di, dv), dt)))
    for dk in ("ip", "l2", "cosine"):
        for parts in ("both", "dense", "sparse"):
            cases.append((f"fused {dk} {parts}", JFused(V, 0.6, -1.7, dk), FusedSpace(V, 0.6, -1.7, dk),
                          ("f", (qd, qi, qv), (dd, di, dv), parts)))
    return cases


@pytest.mark.parametrize("case", _score_pair_cases(), ids=lambda c: c[0])
def test_score_pairs_matches_repro(case):
    _, jspace, tspace, (what, q, d, opt) = case
    if what == "d":
        jq, jd = jnp.asarray(q, getattr(jnp, opt)), jnp.asarray(d, getattr(jnp, opt))
        tq, td = torch.from_numpy(q).to(getattr(torch, opt)), torch.from_numpy(d).to(getattr(torch, opt))
    elif what == "s":
        jq, jd, tq, td = (
            jsp.SparseVectors(jnp.asarray(q[0]), jnp.asarray(q[1], getattr(jnp, opt))),
            jsp.SparseVectors(jnp.asarray(d[0]), jnp.asarray(d[1], getattr(jnp, opt))),
            tsp.SparseVectors(torch.from_numpy(q[0]), torch.from_numpy(q[1]).to(getattr(torch, opt))),
            tsp.SparseVectors(torch.from_numpy(d[0]), torch.from_numpy(d[1]).to(getattr(torch, opt))))
    else:
        keep_d, keep_s = opt in ("both", "dense"), opt in ("both", "sparse")
        jf = lambda x: JFV(jnp.asarray(x[0]) if keep_d else None,
                           jsp.SparseVectors(jnp.asarray(x[1]), jnp.asarray(x[2])) if keep_s else None)
        tf = lambda x: FusedVectors(torch.from_numpy(x[0]) if keep_d else None,
                                    tsp.SparseVectors(torch.from_numpy(x[1]), torch.from_numpy(x[2]))
                                    if keep_s else None)
        jq, jd, tq, td = jf(q), jf(d), tf(q), tf(d)
    want = np.asarray(jspace.score_pairs(jq, jd))
    got = tspace.score_pairs(tq, td)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_scores_close(want, got.numpy())


def test_score_pairs_refuses_no_overlap():
    with pytest.raises(ValueError):
        FusedSpace(V).score_pairs(FusedVectors(torch.zeros(2, 3), None),
                                  FusedVectors(None, tsp.SparseVectors(torch.zeros(2, 1, dtype=torch.int32),
                                                                       torch.zeros(2, 1))))


@pytest.mark.parametrize("kind", ["dense_ip", "fused"])
def test_materialize_matches_repro(kind):
    jspace, tspace, jrows, trows = _case(kind)
    corpus, _ = _base(6)
    jl = JLive(jspace, jrows(corpus), max_append=10 ** 9)
    tl = _port_live(tspace, trows(corpus))
    ops_ = random_schedule(6, 12, D, N0)
    _apply_jax(jl, ops_, jrows)
    apply_schedule_torch(tl, ops_, trows)
    jc, jids = jseg.materialize(jl.snapshot())
    tc, tids = tseg.materialize(tl.snapshot())
    np.testing.assert_array_equal(tids, jids)
    if kind == "fused":
        pairs = [(jc.dense, tc.dense), (jc.sparse.indices, tc.sparse.indices),
                 (jc.sparse.values, tc.sparse.values)]
    else:
        pairs = [(jc, tc)]
    for want, got in pairs:
        np.testing.assert_array_equal(np_of(got), np.asarray(want))


def test_gather_rows_equals_take_then_concat():
    _, _, _, trows = _case("fused")
    a = _port_live(FusedSpace(V), trows(_base(1)[0])).snapshot().main
    b = _port_live(FusedSpace(V), trows(_base(2, n=9)[0])).snapshot().main
    ia, ib = torch.tensor([5, 0, 17, 3]), torch.tensor([8, 1])
    got = tseg._gather_rows([(a, ia), (b, ib)])
    want = tseg.concat_rows(tseg.take_rows(a, ia), tseg.take_rows(b, ib))
    for g, w in zip((got.dense, got.sparse.indices, got.sparse.values),
                    (want.dense, want.sparse.indices, want.sparse.values)):
        assert torch.equal(g, w)
    assert tseg.take_rows(None, ia) is None
    assert tseg.concat_rows(None, a) is a and tseg.concat_rows(a, None) is a
    with pytest.raises(ValueError):
        tseg.concat_rows(a, FusedVectors(a.dense, None))


def test_segment_state_and_locator_are_memoised_per_snapshot():
    corpus, q = _base(4)
    live = _port_live(DenseSpace("ip"), corpus)
    live.delete([1, 2, 3])
    snap = live.snapshot()
    first = tseg._segment_state(snap, "main", torch.device("cpu"))
    assert tseg._segment_state(snap, "main", torch.device("cpu")) is first
    ids, dead, n_dead = first
    assert n_dead == 3 and ids.dtype == torch.int32 and bool(dead[1:4].all())
    assert tseg._locator(snap) is tseg._locator(snap)
    live.delete([4])
    assert tseg._segment_state(live.snapshot(), "main", torch.device("cpu"))[2] == 4


@pytest.mark.parametrize("seed", range(3))
def test_compaction_commutes_with_querying(seed):
    _, tspace, _, trows = _case("fused")
    corpus, q = _base(seed)
    tq = _torch_queries("fused", q)
    live = _port_live(tspace, trows(corpus), "cuda", "streaming")
    apply_schedule_torch(live, random_schedule(seed + 20, 12, D, N0), trows)
    before = live.topk(tq, K)
    snap = live.snapshot()
    compacted = tseg.compact(snap)
    assert compacted.generation == snap.generation + 1 and compacted.n_dead == 0
    assert compacted.n_append == 0 and compacted.n_main == snap.n_live
    after = tseg.live_topk(tspace, compacted, tq, K, main_backend="cuda", append_backend="streaming")
    assert_torch_topk_equal(after, before)


def test_snapshot_validates_and_freezes():
    corpus = torch.zeros(3, 2)
    with pytest.raises(ValueError):
        tseg.SegmentSnapshot(main=corpus, main_ids=np.arange(2), main_dead=np.zeros(2, bool))
    snap = tseg.SegmentSnapshot(main=corpus, main_ids=np.arange(3), main_dead=np.zeros(3, bool))
    with pytest.raises(ValueError):
        snap.main_dead[0] = True
    assert snap.n_live == 3 and snap.live_ids().tolist() == [0, 1, 2]
    assert isinstance(tseg.live_topk(DenseSpace("ip"), snap, torch.ones(1, 2), 2), TopK)


def test_a_short_ann_fetch_gathers_as_repro():
    """A main backend that finds fewer rows than asked pads its answer with
    tail ids past the segment (as the ANN backends do); their dead flags
    and logical ids gather as repro's clamped gathers, and the merge takes
    the append segment's rows in their place."""
    from repro.core import backends as jb
    from repro_torch.core import backends as tb

    class Short:
        name = identity = "short"

        def __init__(self, mod):
            self.mod = mod

        def supports(self, space, corpus):
            return None

        def topk(self, space, q, corpus, k, n_valid=None):
            head = self.mod.ReferenceBackend().topk(space, q, corpus, 2, n_valid)
            return self.mod._reference_tail(head, B, k, n_valid)

    corpus, q = _base(9)
    extra = _base(10, n=6)[0]
    jl = JLive(JDense("ip"), jnp.asarray(corpus), backend=Short(jb), max_append=10 ** 9)
    tl = _port_live(DenseSpace("ip"), corpus, backend=Short(tb))
    for lv, rows in ((jl, jnp.asarray(extra)), (tl, extra)):
        lv.delete([N0 - 1, 3])
        lv.insert(rows)
    got = tl.topk(torch.from_numpy(q), 5)
    assert_topk_match(_np_topk(jl.topk(jnp.asarray(q), 5)), _np_topk(got))
    assert bool(torch.isfinite(got.scores).all())
