"""repro_torch's NAPP (``core/napp.py``, ``NappBackend``, ``NappGenerator``,
``interop.napp_index``) held against repro's on the CPU, on the same numpy
inputs.

``jax.random.choice`` cannot be reproduced, so the build is compared
step by step: repro's pivot ids go into the port's ``napp_membership``,
and searches run over a repro index carried across by
``interop.napp_index``.  Pivot scoring takes the fused score path
(``ops.fused_scores``, its plain version here) for the fused space and
``score_batch`` otherwise, as on the card.  Data is ``benchmarks/
common.py``'s planted-cluster construction, whose scores are exact in
both frameworks where they decide the order, so ids must be equal;
scores agree within ``F32_RTOL`` (2e-6) of the row's largest |score|.
Memberships are compared on rows where the pivot scores leave a margin
at the ``num_index`` cut (or tie exactly).  Recall is held to
``ANN_RECALL_TARGET`` against the exact answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core import napp as jn
from repro.core import pipeline as jp
from repro.core.graph_ann import gather_items as j_gather
from repro.core.spaces import DenseSpace as JDense
from repro.core.spaces import FusedSpace as JFused
from repro.core.spaces import SparseSpace as JSparse
from repro_torch import interop
from repro_torch.core import backends as tb
from repro_torch.core import napp as tn
from repro_torch.core import pipeline as tp
from repro_torch.core.fusion import topk_recall
from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors, SparseSpace
from repro_torch.kernels import sparse_dense as sd

from _torch_parity import F32_RTOL, assert_topk_match, fused_to_torch, to_torch

pytestmark = pytest.mark.torch

V, NNZ, DD = 64, 8, 32
SPACES = ["dense", "sparse", "fused"]


def _data(space, n, b=6, seed=0):
    """(repro space, repro queries, repro corpus, port space, port
    queries, port corpus) on planted-cluster data (8 clusters)."""
    from benchmarks.common import planted_cluster_fused

    jc, jq = planted_cluster_fused(n, V, NNZ, DD, b, 5, seed=seed)
    tc, tq = fused_to_torch(jc), fused_to_torch(jq)
    if space == "dense":
        return JDense("ip"), jq.dense, jc.dense, DenseSpace("ip"), tq.dense, tc.dense
    if space == "sparse":
        return JSparse(V), jq.sparse, jc.sparse, SparseSpace(V), tq.sparse, tc.sparse
    return JFused(V, 0.5, 1.5), jq, jc, FusedSpace(V, 0.5, 1.5), tq, tc


def _index(js, jc, n, p=32, num_index=4, seed=0):
    """A repro NAPP index, and the same index carried into the port."""
    j_index = jn.build_napp(js, jc, n, num_pivots=p, num_index=num_index,
                            key=jax.random.PRNGKey(seed))
    return j_index, interop.napp_index(np.asarray(j_index.pivot_ids),
                                       np.asarray(j_index.membership), num_index, "cpu")


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("block_rows", [tn.NAPP_BLOCK_ROWS, 77])
def test_membership_matches_repro(space, block_rows):
    """The port's membership from repro's pivot ids equals repro's on every
    row whose pivot scores leave a margin at the cut (or tie exactly, which
    both break toward the lower pivot); the blocking changes nothing."""
    n, p, num_index = 512, 32, 4
    js, _, jc, ts, _, tc = _data(space, n, seed=2)
    j_index, _ = _index(js, jc, n, p, num_index, seed=3)
    pivot_ids = torch.from_numpy(np.array(j_index.pivot_ids))
    got = tn.napp_membership(ts, tc, pivot_ids, p, num_index, block_rows=block_rows)
    assert got.shape == (n, p) and got.dtype == torch.float32
    assert torch.equal(got.sum(1), torch.full((n,), float(num_index)))
    s = np.sort(np.asarray(js.score_batch(j_gather(jc, j_index.pivot_ids), jc)).T, axis=1)[:, ::-1]
    gap = s[:, num_index - 1] - s[:, num_index]
    scale = np.abs(s).max(1)
    clear = (gap > 4 * F32_RTOL * scale) | (gap == 0)
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(j_index.membership)[clear])


def test_membership_through_the_fused_score_path(monkeypatch):
    """A fused ip corpus scores its pivots through ``ops.fused_scores``
    (one call per row block); other spaces keep ``score_batch``."""
    n = 304
    _, _, _, ts, _, tc = _data("fused", n)
    calls = []
    real = sd.fused_score
    monkeypatch.setattr(sd, "fused_score", lambda *a: calls.append(a[4].shape[0]) or real(*a))
    pivot_ids = torch.arange(0, 40, 2, dtype=torch.int32)
    tn.napp_membership(ts, tc, pivot_ids, 20, 4, block_rows=128)
    assert calls == [128, 128, 48]
    assert tn.fused_kernel_serves(ts, tc, tc)
    assert not tn.fused_kernel_serves(FusedSpace(V, dense_kind="l2"), tc, tc)
    assert not tn.fused_kernel_serves(ts, FusedVectors(tc.dense, None), tc)
    assert not tn.fused_kernel_serves(ts, FusedVectors(tc.dense.half(), tc.sparse), tc)
    assert not tn.fused_kernel_serves(DenseSpace(), tc.dense, tc.dense)
    calls.clear()
    tn.napp_membership(DenseSpace(), tc.dense, pivot_ids, 20, 4)
    assert calls == []


def test_pivot_draw_and_build():
    n = 1000
    g = torch.Generator().manual_seed(5)
    ids = tn.draw_pivots(n, 64, g)
    assert ids.dtype == torch.int32 and len(set(ids.tolist())) == 64
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    again = tn.draw_pivots(n, 64, torch.Generator().manual_seed(5))
    assert torch.equal(ids, again)
    _, _, _, ts, _, tc = _data("dense", 256)
    index = tn.build_napp(ts, tc, 200, num_pivots=16, num_index=3)
    assert index.num_index == 3 and index.membership.shape == (256, 16)
    assert int(index.pivot_ids.max()) < 200
    assert torch.equal(index.pivot_ids, tn.build_napp(ts, tc, 200, 16, 3).pivot_ids)


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("rerank_qty", [16, 256])
def test_napp_search_matches_repro(space, rerank_qty):
    """Over the same index, ids equal.  With 16 candidates most of a
    64-row cluster ties on counts and the lower ids must win."""
    n = 512
    js, jq, jc, ts, tq, tc = _data(space, n, b=8, seed=4)
    j_index, t_index = _index(js, jc, n, p=64, num_index=8, seed=1)
    for k, num_search, min_times in ((10, 8, 2), (5, 4, 1)):
        want = jn.napp_search(js, jq, jc, j_index, k=k, num_search=num_search,
                              min_times=min_times, rerank_qty=rerank_qty)
        got = tn.napp_search(ts, tq, tc, t_index, k=k, num_search=num_search,
                             min_times=min_times, rerank_qty=rerank_qty)
        assert got.indices.dtype == torch.int32
        assert_topk_match(want, got, ctx=(space, rerank_qty, k))


def test_count_ties_go_to_the_lower_id():
    """Every item shares both probed pivots: all counts tie, so the
    candidates are the lowest ``rerank_qty`` ids, although higher ids
    score better."""
    n, p = 40, 4
    corpus = np.zeros((n, n + p), np.float32)
    corpus[np.arange(n), np.arange(n)] = np.arange(1, n + 1, dtype=np.float32)
    corpus[:, n:n + 2] = 1.0                      # every item near pivots 0 and 1
    query = np.zeros((1, n + p), np.float32)
    query[0, :n] = 1.0
    query[0, n:n + 2] = 10.0
    member = np.zeros((n, p), np.float32)
    member[:, :2] = 1.0
    pivot_ids = np.array([n - 1, n - 2, n - 3, n - 4], np.int32)   # query's best two first
    j_index = jn.NappIndex(jnp.asarray(pivot_ids), jnp.asarray(member), 2)
    want = jn.napp_search(JDense(), jnp.asarray(query), jnp.asarray(corpus), j_index, k=5,
                          num_search=2, min_times=2, rerank_qty=8)
    t_index = interop.napp_index(pivot_ids, member, 2, "cpu")
    got = tn.napp_search(DenseSpace(), to_torch(query), to_torch(corpus), t_index, k=5,
                         num_search=2, min_times=2, rerank_qty=8)
    assert got.indices.tolist() == [[7, 6, 5, 4, 3]]
    assert_topk_match(want, got)


def test_degenerate_tail_matches_repro():
    """After repro's TestNappDegenerateTail: fewer passing candidates than
    k leave -inf slots with ids n, n+1, ... ."""
    member = np.zeros((8, 4), np.float32)
    member[0, :2] = member[1, :2] = member[2, 2:] = 1.0
    corpus = np.eye(8, dtype=np.float32)
    query = np.zeros((1, 8), np.float32)
    query[0, 0], query[0, 1] = 3.0, 2.0
    pivot_ids = np.arange(4, dtype=np.int32)
    want = jn.napp_search(JDense(), jnp.asarray(query), jnp.asarray(corpus),
                          jn.NappIndex(jnp.asarray(pivot_ids), jnp.asarray(member), 2),
                          k=5, num_search=2, min_times=2, rerank_qty=6)
    got = tn.napp_search(DenseSpace(), to_torch(query), to_torch(corpus),
                         interop.napp_index(pivot_ids, member, 2, "cpu"),
                         k=5, num_search=2, min_times=2, rerank_qty=6)
    assert got.indices.tolist() == [[0, 1, 8, 9, 10]]
    assert got.scores[0, :2].tolist() == [3.0, 2.0] and torch.isneginf(got.scores[0, 2:]).all()
    assert_topk_match(want, got)


def test_identity_and_registry_match_repro():
    configs = [{}, dict(num_search=4), dict(num_pivots=64, num_index=6, num_search=12,
                                            min_times=1, rerank_qty=32, seed=3)]
    for cfg in configs:
        assert tb.NappBackend(**cfg).identity == jb.NappBackend(**cfg).identity
    assert tb.make_backend("napp").identity == jb.make_backend("napp").identity
    assert tb.resolve_backend("napp", DenseSpace(), [1, 2]).identity == "reference"
    assert tb.NappBackend().supports(DenseSpace(), torch.zeros(3, 2)) is None


@pytest.mark.parametrize("space", SPACES)
def test_backend_matches_repro_on_a_repro_index(space, monkeypatch):
    """The backend's clamps and search over the same index as repro's
    backend: ids equal (the index is swapped in for the port's draw)."""
    n = 256
    js, jq, jc, ts, tq, tc = _data(space, n, b=4, seed=8)
    cfg = dict(num_pivots=300, num_index=12, num_search=40, rerank_qty=300)
    jb.clear_ann_index_cache()
    want = jb.NappBackend(**cfg).topk(js, jq, jc, 10, n_valid=200)
    _, j_index = jb._ANN_INDEX_CACHE.popitem()[1][2]
    jb.clear_ann_index_cache()
    t_index = interop.napp_index(np.asarray(j_index.pivot_ids), np.asarray(j_index.membership),
                                 j_index.num_index, "cpu")
    assert t_index.membership.shape == (200, 200) and t_index.num_index == 12
    tb.clear_ann_index_cache()
    monkeypatch.setattr(tn, "build_napp", lambda *a, **k: t_index)
    got = tb.NappBackend(**cfg).topk(ts, tq, tc, 10, n_valid=200)
    assert_topk_match(want, got, ctx=space)
    tb.clear_ann_index_cache()


def test_rerank_budget_boundary_and_refusal():
    n = 512
    _, _, _, ts, tq, tc = _data("dense", n, b=4)
    backend = tb.NappBackend(rerank_qty=12, num_search=16, min_times=1)
    got = backend.topk(ts, tq, tc, 12)
    assert got.indices.shape == (4, 12)
    assert all(len(set(row)) == 12 for row in got.indices.tolist())
    with pytest.raises(ValueError, match="rerank_qty=12"):
        backend.topk(ts, tq, tc, 13)


def test_reference_tail_beyond_n_valid():
    n = 512
    js, jq, jc, ts, tq, tc = _data("dense", n, b=4)
    want = jb.NappBackend().topk(js, jq, jc, 12, n_valid=8)
    got = tb.NappBackend().topk(ts, tq, tc, 12, n_valid=8)
    assert got.indices[:, 8:].tolist() == [[8, 9, 10, 11]] * 4
    assert torch.isneginf(got.scores[:, 8:]).all()
    assert np.array_equal(np.asarray(want.indices)[:, 8:], got.indices[:, 8:].numpy())
    empty = tb.NappBackend().topk(ts, tq, tc, 3, n_valid=0)
    assert empty.indices.tolist() == [[0, 1, 2]] * 4


def test_ann_index_cache_counts():
    n = 128
    _, _, _, ts, tq, tc = _data("dense", n, b=4)
    _, _, _, _, _, other = _data("dense", n, b=4, seed=1)
    tb.clear_ann_index_cache()
    napp = tb.NappBackend(num_pivots=16)
    napp.topk(ts, tq, tc, 5)
    napp.topk(ts, tq, tc, 5)
    assert tb.ann_index_cache_info() == {"size": 1, "hits": 1, "misses": 1}
    tb.NappBackend(num_pivots=16, num_search=4).topk(ts, tq, tc, 5)   # search params: same index
    assert tb.ann_index_cache_info() == {"size": 1, "hits": 2, "misses": 1}
    tb.NappBackend(num_pivots=16, seed=1).topk(ts, tq, tc, 5)         # build params: another
    napp.topk(ts, tq, tc, 5, n_valid=100)
    napp.topk(ts, tq, other, 5)
    tb.GraphANNBackend(rounds=0).topk(ts, tq, tc, 5)                   # the kind is in the key
    assert tb.ann_index_cache_info() == {"size": 5, "hits": 2, "misses": 5}
    assert tb.invalidate_ann_index_entries(tc) == 4
    assert tb.ann_index_cache_info()["size"] == 1
    napp.topk(ts, tq, other, 5)
    assert tb.ann_index_cache_info() == {"size": 1, "hits": 3, "misses": 5}
    tb.clear_ann_index_cache()


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("space", SPACES)
def test_backend_recall_through_pipeline(space, k):
    """At repro's recall-test sizes (512 rows, 8 clusters, 16 queries),
    the port's own pivot draw: recall@k against the exact answer."""
    n, b = 512, 16
    _, _, _, ts, tq, tc = _data(space, n, b=b)
    exact = tb.CudaBackend().topk(ts, tq, tc, k)
    tb.clear_ann_index_cache()
    backend = tb.resolve_backend("napp", ts, tc)
    assert isinstance(backend, tb.NappBackend)
    pipe = tp.RetrievalPipeline(tp.BruteForceGenerator(ts, tc, backend=backend),
                                cand_qty=k, final_qty=k)
    got = pipe.run(tq)
    assert got.indices.shape == (b, k) and got.indices.dtype == torch.int32
    assert topk_recall(exact.indices, got.indices) >= tb.ANN_RECALL_TARGET
    tb.clear_ann_index_cache()


def test_napp_generator_matches_repro():
    n = 256
    js, jq, jc, ts, tq, tc = _data("fused", n, seed=6)
    j_index, t_index = _index(js, jc, n, p=32, num_index=6)
    want = jp.NappGenerator(js, jc, j_index, num_search=6, rerank_qty=8).generate(jq, 12)
    got = tp.NappGenerator(ts, tc, t_index, num_search=6, rerank_qty=8).generate(tq, 12)
    assert_topk_match(want, got)          # rerank_qty grows to k = 12
    got = tp.RetrievalPipeline(tp.NappGenerator(ts, tc, t_index), cand_qty=20, final_qty=5).run(tq)
    want = jp.RetrievalPipeline(jp.NappGenerator(js, jc, j_index), cand_qty=20, final_qty=5).run(jq)
    assert got.indices.shape == (6, 5)
    assert_topk_match(want, got)


def test_napp_index_interop():
    idx = interop.napp_index(np.array([3, 1], np.int64), np.eye(4, 2), 1, "cpu")
    assert isinstance(idx, tn.NappIndex) and idx.num_index == 1
    assert idx.pivot_ids.dtype == torch.int32 and idx.membership.dtype == torch.float32
    assert idx.pivot_ids.tolist() == [3, 1] and idx.membership.shape == (4, 2)
