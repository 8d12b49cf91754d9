"""repro_torch's graph ANN (``core/graph_ann.py``, ``GraphANNBackend``,
``GraphANNGenerator``) held against repro's on the CPU, on the same numpy
inputs and on graphs carried across by ``interop.graph_index``.

The JAX side runs as repro's own tests run it (the kernel traversal in
Pallas interpret mode); the port's kernel wrappers run their plain
versions.  Data is ``benchmarks/common.py``'s planted-cluster
construction, whose scores are exact in both frameworks where they
decide the order, so ids must be equal; scores agree within
``F32_RTOL`` (2e-6) of the row's largest |score|.  Recall is held to
``ANN_RECALL_TARGET`` against the exact answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core import graph_ann as jga
from repro.core import pipeline as jp
from repro.core.spaces import DenseSpace as JDense
from repro.core.spaces import FusedSpace as JFused
from repro.core.spaces import SparseSpace as JSparse
from repro_torch import interop
from repro_torch.core import backends as tb
from repro_torch.core import graph_ann as tga
from repro_torch.core import pipeline as tp
from repro_torch.core.fusion import topk_recall
from repro_torch.core.spaces import DenseSpace, FusedSpace, SparseSpace
from repro_torch.kernels import beam_topk

from _torch_parity import assert_scores_close, assert_topk_match, fused_to_torch

pytestmark = pytest.mark.torch

V, NNZ, DD = 64, 8, 32
SPACES = ["dense-ip", "dense-l2", "sparse", "fused"]


def _data(space, n, b=6, seed=0):
    """(repro space, repro queries, repro corpus, port space, port
    queries, port corpus) on planted-cluster data (8 clusters)."""
    from benchmarks.common import planted_cluster_fused

    jc, jq = planted_cluster_fused(n, V, NNZ, DD, b, 5, seed=seed)
    tc, tq = fused_to_torch(jc), fused_to_torch(jq)
    if space.startswith("dense"):
        kind = space[-2:]
        return JDense(kind), jq.dense, jc.dense, DenseSpace(kind), tq.dense, tc.dense
    if space == "sparse":
        return JSparse(V), jq.sparse, jc.sparse, SparseSpace(V), tq.sparse, tc.sparse
    return JFused(V, 0.5, 1.5), jq, jc, FusedSpace(V, 0.5, 1.5), tq, tc


def _jax_draws(n, r, seed):
    """The draws repro's ``nn_descent`` makes for its start graph and its
    first round."""
    key = jax.random.PRNGKey(seed)
    k0, _ = jax.random.split(key)
    start = jax.random.randint(k0, (n, r), 0, n, dtype=jnp.int32)
    _, rk = jax.random.split(key)
    rand = jax.random.randint(rk, (n, max(4, r // 4)), 0, n, dtype=jnp.int32)
    return np.array(start), np.array(rand)


def _graph(js, jc, n, r=8, rounds=2, seed=0):
    """A repro NN-descent graph, carried into the port."""
    index = jga.nn_descent(js, jc, n, degree=r, rounds=rounds,
                           key=jax.random.PRNGKey(seed), node_block=n // 2)
    return index, interop.graph_index(np.asarray(index.neighbors),
                                      np.asarray(index.entry_ids), "cpu")


@pytest.mark.parametrize("n,count", [(1, None), (7, None), (256, None), (1000, 31),
                                     (123_457, None), (1_048_576, None), (8_841_823, None),
                                     (500, 64)])
def test_entry_sample_matches_repro(n, count):
    e = min(n, count or max(16, int(n ** 0.5)))
    want = np.asarray(jnp.linspace(0, n - 1, e).astype(jnp.int32))
    np.testing.assert_array_equal(want, tga.entry_sample(n, count).numpy())


def test_default_hops_and_flat_adjacency():
    for n in (1, 10, 512, 1_048_576, 8_841_823):
        assert tga.default_hops(n) == jga.default_hops(n)
    assert tga.default_hops(8_841_823) == 31
    lists = [[1, 2, 3, 4, 5], [], [0], [2, 2]]
    for sentinel in (None, 9):
        want = np.asarray(jga.flat_adjacency(lists, 4, 3, sentinel))
        got = tga.flat_adjacency(lists, 4, 3, sentinel, device="cpu")
        np.testing.assert_array_equal(want, got.numpy())
        assert got.dtype == torch.int32
    with pytest.raises(ValueError, match="rows for"):
        tga.flat_adjacency(lists, 5, 3, device="cpu")


@pytest.mark.parametrize("space", SPACES + ["dense-cosine"])
def test_gather_and_score_many_match_repro(space):
    js, jq, jc, ts, tq, tc = _data("fused" if space == "dense-cosine" else space, 64)
    if space == "dense-cosine":
        js, jq, jc, ts, tq, tc = JDense("cosine"), jq.dense, jc.dense, DenseSpace("cosine"), \
            tq.dense, tc.dense
    ids = np.random.default_rng(1).integers(0, 64, (6, 20)).astype(np.int32)
    ids[:, -1] = 64                                  # a sentinel reads the last row
    want = jga.score_many(js, jq, jga.gather_items(jc, jnp.asarray(ids)))
    got = tga.score_many(ts, tq, tga.gather_items(tc, torch.from_numpy(ids)))
    assert_scores_close(np.asarray(want), got.numpy())


@pytest.mark.parametrize("item_id", [-1, -7, 13, -2, -8, -11, -12, 10])
def test_score_many_indexes_out_of_range_sparse_ids_as_repro(item_id):
    """A SparseSpace's one-vs-many scores on item ids outside [0, V]
    (V = 10, query terms {0: 2, 3: 5}): repro pads the densified queries
    to V+1 columns and indexes them with qrow[it_idx] (a negative id
    counts from the end once, then ids clamp to [0, V]); the port does
    the same."""
    from repro.core.sparse import SparseVectors as JSV
    from repro_torch.core.sparse import SparseVectors as TSV

    v = 10
    qi, qv = np.asarray([[0, 3]], np.int32), np.asarray([[2.0, 5.0]], np.float32)
    ii, iv = np.asarray([[[item_id, 3]]], np.int32), np.asarray([[[1.0, 0.5]]], np.float32)
    want = jga.score_many(JSparse(v), JSV(jnp.asarray(qi), jnp.asarray(qv)),
                          JSV(jnp.asarray(ii), jnp.asarray(iv)))
    got = tga.score_many(SparseSpace(v), TSV(torch.from_numpy(qi), torch.from_numpy(qv)),
                         TSV(torch.from_numpy(ii), torch.from_numpy(iv)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("space", SPACES)
def test_nn_descent_round_matches_repro(space):
    """One refinement round fed the draws jax.random made gives repro's
    ``nn_descent(rounds=1)`` adjacency exactly, for any node block."""
    n, r, seed = 256, 8, 3
    js, _, jc, ts, _, tc = _data(space, n, seed=seed)
    want = jga.nn_descent(js, jc, n, degree=r, rounds=1, key=jax.random.PRNGKey(seed),
                          node_block=64)
    start, rand = _jax_draws(n, r, seed)
    got = tga.nn_descent_round(ts, tc, torch.from_numpy(start), torch.from_numpy(rand))
    np.testing.assert_array_equal(np.asarray(want.neighbors), got.numpy())
    ragged = tga.nn_descent_round(ts, tc, torch.from_numpy(start), torch.from_numpy(rand),
                                  node_block=37)
    np.testing.assert_array_equal(got.numpy(), ragged.numpy())
    np.testing.assert_array_equal(np.asarray(want.entry_ids), tga.entry_sample(n).numpy())


def test_nn_descent_draws_and_shapes():
    """The port's own draws: a seeded generator gives the same graph twice,
    ``rounds=0`` keeps the random start, ids stay in range and no node
    lists itself after a round."""
    n = 200
    _, _, _, ts, _, tc = _data("dense-ip", n)
    g = lambda: torch.Generator().manual_seed(5)   # noqa: E731
    a = tga.nn_descent(ts, tc, n, degree=6, rounds=2, generator=g())
    b = tga.nn_descent(ts, tc, n, degree=6, rounds=2, generator=g())
    assert torch.equal(a.neighbors, b.neighbors) and a.neighbors.dtype == torch.int32
    start = tga.nn_descent(ts, tc, n, degree=6, rounds=0, generator=g())
    assert torch.equal(start.neighbors,
                       torch.randint(0, n, (n, 6), generator=g(), dtype=torch.int32))
    nbr = a.neighbors.numpy()
    assert nbr.min() >= 0 and nbr.max() < n
    assert not (nbr == np.arange(n)[:, None]).any()


@pytest.mark.parametrize("space", SPACES)
def test_beam_search_matches_repro(space):
    """The plain traversal walks a repro graph to repro's answer, also
    on a flat_adjacency graph padded with the sentinel (whose candidates
    read the last row) and in the early-exit variant."""
    n = 256
    js, jq, jc, ts, tq, tc = _data(space, n, seed=2)
    j_index, t_index = _graph(js, jc, n)
    for k, ef, hops in ((5, 8, 4), (10, 16, None)):
        want = jga.beam_search(js, jq, jc, j_index, n, k=k, ef=ef, hops=hops)
        got = tga.beam_search(ts, tq, tc, t_index, n, k=k, ef=ef, hops=hops)
        assert_topk_match(want, got, ctx=(space, k, ef))
    if space != "dense-l2":
        # a starved beam reaches other clusters' rows, whose l2 scores
        # tie exactly in real arithmetic (same rank, equal norms), so
        # only rounding orders them there
        lists = [np.asarray(j_index.neighbors)[i, :i % 5].tolist() for i in range(n)]
        pad = jga.GraphIndex(jga.flat_adjacency(lists, n, 8), j_index.entry_ids[:3])
        t_pad = interop.graph_index(np.asarray(pad.neighbors), np.asarray(pad.entry_ids),
                                    "cpu")
        assert_topk_match(jga.beam_search(js, jq, jc, pad, n, k=5, ef=8, hops=3),
                          tga.beam_search(ts, tq, tc, t_pad, n, k=5, ef=8, hops=3))
    assert_topk_match(jga.beam_search_early_exit(js, jq, jc, j_index, n, k=5, ef=8, max_hops=6),
                      tga.beam_search_early_exit(ts, tq, tc, t_index, n, k=5, ef=8, max_hops=6))


@pytest.mark.parametrize("space", SPACES)
def test_kernel_beam_search_matches_repro(space):
    """The kernel traversal (plain hop on the CPU) against repro's
    (interpret mode) on the same graph, and on a starved one: three
    entries, no edges, k above what is reachable."""
    n = 256
    js, jq, jc, ts, tq, tc = _data(space, n, seed=4)
    j_index, t_index = _graph(js, jc, n)
    want = jga.kernel_beam_search(js, jq, jc, j_index, n, k=10, ef=16, hops=5)
    got = tga.kernel_beam_search(ts, tq, tc, t_index, n, k=10, ef=16, hops=5)
    assert_topk_match(want, got, ctx=space)
    empty = jga.GraphIndex(jga.flat_adjacency([[] for _ in range(n)], n, 4),
                           jnp.asarray([3, 9, 27], jnp.int32))
    t_empty = interop.graph_index(np.asarray(empty.neighbors), [3, 9, 27], "cpu")
    want = jga.kernel_beam_search(js, jq, jc, empty, n, k=6, ef=8, hops=2)
    got = tga.kernel_beam_search(ts, tq, tc, t_empty, n, k=6, ef=8, hops=2)
    assert_topk_match(want, got, ctx=f"{space} starved")
    assert got.indices[:, 3:].tolist() == [[n, n + 1, n + 2]] * got.indices.shape[0]


def _pipeline(ts, tc, backend):
    return tp.RetrievalPipeline(tp.BruteForceGenerator(ts, tc, backend=backend),
                                cand_qty=10, final_qty=10)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("space", ["dense-ip", "sparse", "fused"])
def test_backend_recall_through_pipeline(space, kernel):
    n, b, k = 512, 16, 10
    _, _, _, ts, tq, tc = _data(space, n, b=b)
    exact = tb.CudaBackend().topk(ts, tq, tc, k)
    tb.clear_ann_index_cache()
    backend = tb.resolve_backend("graph_ann", ts, tc, kernel=kernel)
    assert isinstance(backend, tb.GraphANNBackend) and backend.kernel == kernel
    got = _pipeline(ts, tc, backend).run(tq)
    assert got.indices.shape == (b, k) and got.indices.dtype == torch.int32
    assert topk_recall(exact.indices, got.indices) >= tb.ANN_RECALL_TARGET


def test_identity_matches_repro():
    configs = [{}, dict(kernel=True), dict(degree=8, rounds=0, ef=32, hops=5, entry_count=40,
                                           seed=3, kernel=True)]
    for cfg in configs:
        assert tb.GraphANNBackend(**cfg).identity == jb.GraphANNBackend(**cfg).identity
    assert tb.make_backend("graph_ann").identity == jb.make_backend("graph_ann").identity
    assert "graph_ann" in tb.available_backends()
    assert tb.backend_identity(tb.GraphANNBackend(kernel=True)).endswith("kernel=on)")


def test_capability_fallback_and_refusals():
    n = 64
    _, _, _, ts, tq, tc = _data("dense-ip", n, b=4)
    cos = DenseSpace("cosine")
    assert tb.resolve_backend("graph_ann", cos, tc, kernel=True).identity == "reference"
    assert jb.resolve_backend("graph_ann", JDense("cosine"), jnp.asarray(tc.numpy()),
                              kernel=True).identity == "reference"
    plain = tb.resolve_backend("graph_ann", cos, tc)
    assert plain.name == "graph_ann" and not plain.kernel
    why = tb.GraphANNBackend(kernel=True).supports(FusedSpace(V, dense_kind="l2"),
                                                   _data("fused", n)[5])
    assert why is not None and why.startswith("graph_ann kernel path:")
    assert tb.GraphANNBackend().supports(DenseSpace(), [1, 2]) is not None
    with pytest.raises(ValueError, match="ef=8"):
        tb.GraphANNBackend(ef=8, kernel=True).topk(ts, tq, tc, 10)
    with pytest.raises(ValueError, match="candidate block"):
        tb.GraphANNBackend(ef=4096, degree=16, kernel=True).topk(ts, tq, tc, 5)
    beam_topk.check_beam_budget(64, 16)


@pytest.mark.parametrize("kernel", [True, False])
def test_reference_tail_beyond_n_valid(kernel):
    n = 512
    js, jq, jc, ts, tq, tc = _data("dense-ip", n, b=4)
    want = jb.GraphANNBackend(kernel=kernel).topk(js, jq, jc, 12, n_valid=8)
    got = tb.GraphANNBackend(kernel=kernel).topk(ts, tq, tc, 12, n_valid=8)
    assert got.indices[:, 8:].tolist() == [[8, 9, 10, 11]] * 4
    assert torch.isneginf(got.scores[:, 8:]).all()
    assert np.array_equal(np.asarray(want.indices)[:, 8:], got.indices[:, 8:].numpy())
    empty = tb.GraphANNBackend(kernel=kernel).topk(ts, tq, tc, 3, n_valid=0)
    assert empty.indices.tolist() == [[0, 1, 2]] * 4


def test_ann_index_cache_counts():
    n = 128
    _, _, _, ts, tq, tc = _data("dense-ip", n, b=4)
    _, _, _, _, _, other = _data("dense-ip", n, b=4, seed=1)
    tb.clear_ann_index_cache()
    on, off = tb.GraphANNBackend(kernel=True, rounds=1), tb.GraphANNBackend(rounds=1)
    on.topk(ts, tq, tc, 5)
    on.topk(ts, tq, tc, 5)
    assert tb.ann_index_cache_info() == {"size": 1, "hits": 1, "misses": 1}
    off.topk(ts, tq, tc, 5)                  # the kernel flag is part of the key
    on.topk(ts, tq, tc, 5, n_valid=100)      # so is the n_valid slice
    on.topk(ts, tq, other, 5)
    assert tb.ann_index_cache_info() == {"size": 4, "hits": 1, "misses": 4}
    assert tb.invalidate_ann_index_entries(tc) == 3
    assert tb.ann_index_cache_info()["size"] == 1
    on.topk(ts, tq, other, 5)
    assert tb.ann_index_cache_info() == {"size": 1, "hits": 2, "misses": 4}
    for seed in range(tb._ANN_INDEX_CAPACITY + 2):     # bounded LRU
        tb.GraphANNBackend(rounds=0, seed=seed).topk(ts, tq, tc, 5)
    assert tb.ann_index_cache_info()["size"] == tb._ANN_INDEX_CAPACITY
    tb.clear_ann_index_cache()
    assert tb.ann_index_cache_info() == {"size": 0, "hits": 0, "misses": 0}


def test_graph_ann_generator_matches_repro():
    n = 256
    js, jq, jc, ts, tq, tc = _data("fused", n, seed=6)
    j_index, t_index = _graph(js, jc, n)
    want = jp.GraphANNGenerator(js, jc, j_index, n, ef=8, hops=4).generate(jq, 12)
    got = tp.GraphANNGenerator(ts, tc, t_index, n, ef=8, hops=4).generate(tq, 12)
    assert_topk_match(want, got)
    got = tp.RetrievalPipeline(tp.GraphANNGenerator(ts, tc, t_index, n), cand_qty=20,
                               final_qty=5).run(tq)
    assert got.indices.shape == (6, 5)


def test_graph_index_interop():
    idx = interop.graph_index(np.arange(6, dtype=np.int64).reshape(3, 2), [0, 2], "cpu")
    assert isinstance(idx, tga.GraphIndex)
    assert idx.neighbors.dtype == torch.int32 and idx.entry_ids.dtype == torch.int32
    assert idx.neighbors.tolist() == [[0, 1], [2, 3], [4, 5]]
