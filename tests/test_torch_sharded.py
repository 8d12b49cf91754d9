"""repro_torch.serving.sharded: contiguous row shards that are views of the
corpus, merged in row order, held against ``repro``'s ``ShardedPipeline``
and the unsharded run (ids equal, scores within ``F32_RTOL``), offline
and served.  The kernel backend ``cuda`` runs its plain versions here.
"""

import numpy as np
import pytest
import torch

from repro.core.spaces import FusedSpace as JFused
from repro.serving.sharded import ShardedPipeline as JSharded
from repro_torch.core import pipeline as tp
from repro_torch.core.spaces import DenseSpace, FusedSpace
from repro_torch.serving import EndpointSpec, RetrievalService, ShardedPipeline, shard_corpus

from _torch_parity import (FrozenClock, assert_topk_match, batched_offline, fused_to_torch,
                           jnp_fused, planted_fused_np, serve_in_order)

pytestmark = pytest.mark.torch

N, V, NNZ, DD, B = 101, 40, 6, 8, 12   # N prime: 3 and 4 shards are uneven


@pytest.fixture(scope="module")
def fused():
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(N, V, NNZ, DD, B, 10, seed=11)
    jc, jq = jnp_fused((cd, ci, cv)), jnp_fused((qd, qi, qv))
    return jc, jq, fused_to_torch(jc), fused_to_torch(jq)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shards_are_views_in_row_order(fused, n_shards):
    _, _, tc, _ = fused
    shards = shard_corpus(tc, n_shards)
    assert sum(s.n_rows for s in shards) == N
    assert [s.offset for s in shards] == [N * i // n_shards for i in range(n_shards)]
    for s in shards:
        for leaf, part in ((tc.dense, s.corpus.dense), (tc.sparse.indices, s.corpus.sparse.indices),
                           (tc.sparse.values, s.corpus.sparse.values)):
            assert part.shape[0] == s.n_rows
            assert part.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr()
            assert part.data_ptr() == leaf.data_ptr() + s.offset * leaf.stride(0) * leaf.element_size()


def test_shard_count_and_placement_are_checked(fused):
    _, _, tc, _ = fused
    for bad in (0, N + 1):
        with pytest.raises(ValueError, match="n_shards"):
            shard_corpus(tc, bad)

    class Ctx:
        mesh = object()

    with pytest.raises(NotImplementedError, match="distributed layer"):
        shard_corpus(tc, 2, ctx=Ctx())


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_equals_repro_and_unsharded(fused, n_shards, backend):
    jc, jq, tc, tq = fused
    jspace, tspace = JFused(V, 0.6, 0.4), FusedSpace(V, 0.6, 0.4)
    with ShardedPipeline.from_corpus(tspace, tc, n_shards, backend=backend, cand_qty=30,
                                     final_qty=10) as pipe:
        got = pipe.run(tq)
        cands = pipe.generate(tq, 30)
    with JSharded.from_corpus(jspace, jc, n_shards, cand_qty=30, final_qty=10) as jpipe:
        want = jpipe.run(jq)
    assert_topk_match(want, got, ctx=f"{n_shards} shards")
    flat = tp.RetrievalPipeline(tp.BruteForceGenerator(tspace, tc, backend=backend),
                                cand_qty=30, final_qty=10)
    assert torch.equal(got.indices, flat.run(tq).indices)
    assert torch.equal(cands.indices, flat.generate_candidates(tq).indices)
    assert pipe.executor is None     # closed


def test_dense_shards_with_k_above_a_shard(fused):
    """A shard smaller than k contributes all its rows."""
    _, _, tc, tq = fused
    with ShardedPipeline.from_corpus(DenseSpace("ip"), tc.dense, 4, backend="cuda") as pipe:
        got = pipe.generate(tq.dense, 40)
    want = tp.BruteForceGenerator(DenseSpace("ip"), tc.dense).generate(tq.dense, 40)
    assert torch.equal(got.indices, want.indices)


def test_rebinds_keep_the_shards(fused):
    _, _, tc, tq = fused
    tspace = FusedSpace(V, 0.6, 0.4)
    pipe = ShardedPipeline.from_corpus(tspace, tc, 3, cand_qty=30, final_qty=10)
    try:
        rebound = pipe.with_backend("cuda")
        try:
            assert {type(g.backend).__name__ for g in rebound.generators} == {"CudaBackend"}
            assert rebound.executor is not pipe.executor and rebound.shards == pipe.shards
            assert torch.equal(rebound.run(tq).indices, pipe.run(tq).indices)
        finally:
            rebound.close()
        bf16 = pipe.with_corpus_dtype("bfloat16")
        try:
            assert bf16.corpus_dtype == "bfloat16"
            assert bf16.shards[0].corpus.dense.dtype == torch.bfloat16
        finally:
            bf16.close()
    finally:
        pipe.close()


def test_served_sharded_endpoint_equals_its_offline_batches(fused):
    jc, jq, tc, tq = fused
    tspace = FusedSpace(V, 0.6, 0.4)
    items = [type(tq)(tq.dense[i], type(tq.sparse)(tq.sparse.indices[i], tq.sparse.values[i]))
             for i in range(B)]
    pipe = ShardedPipeline.from_corpus(tspace, tc, 3, backend="cuda", cand_qty=30, final_qty=10)
    clock = FrozenClock()
    with RetrievalService(cache_size=0, time_fn=clock) as svc:
        svc.register_pipeline("sharded", pipe, items[0], spec=EndpointSpec(batch_size=8))
        rows = [f.result() for f in serve_in_order(svc, "sharded", items, clock)]
        ep = svc.snapshot().endpoints["sharded"]
    want = batched_offline(pipe.run, items, items[0], 8)
    for i, (g, w) in enumerate(zip(rows, want)):
        assert np.array_equal(g.indices, w.indices), i
        assert np.array_equal(g.scores.view(np.int32), w.scores.view(np.int32)), i
    with JSharded.from_corpus(JFused(V, 0.6, 0.4), jc, 3, cand_qty=30, final_qty=10) as jpipe:
        jwant = jpipe.run(jq)
    np.testing.assert_array_equal(np.stack([r.indices for r in rows]), np.asarray(jwant.indices))
    assert ep.backend == "cuda" and ep.n_batches == 2
    pipe.close()
