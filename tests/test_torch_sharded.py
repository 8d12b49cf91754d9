"""repro_torch.serving.sharded: contiguous row shards that are views of the
corpus, merged in row order, held against ``repro``'s ``ShardedPipeline``
and the unsharded run (ids equal, scores within ``F32_RTOL``), offline
and served, and placed over a 4-rank ``DeviceMesh`` of gloo ranks.  The
kernel backend ``cuda`` runs its plain versions here.

``repro`` is imported inside the tests: the mesh cases' ranks import this
module, and they need no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pipeline as tp
from repro_torch.core.spaces import DenseSpace, FusedSpace
from repro_torch.serving import EndpointSpec, RetrievalService, ShardedPipeline, shard_corpus

from _torch_parity import (FrozenClock, assert_topk_match, batched_offline, fused_to_torch,
                           jnp_fused, planted_fused_np, run_ranks, serve_in_order)

pytestmark = pytest.mark.torch

N, V, NNZ, DD, B = 101, 40, 6, 8, 12   # N prime: 3 and 4 shards are uneven


def _repro():
    """``repro``'s FusedSpace and ShardedPipeline."""
    from repro.core.spaces import FusedSpace
    from repro.serving.sharded import ShardedPipeline as JSharded

    return FusedSpace, JSharded


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

    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_corpus(tc, 2, ctx=Ctx())


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_equals_repro_and_unsharded(fused, n_shards, backend):
    jc, jq, tc, tq = fused
    JFused, JSharded = _repro()
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
    JFused, JSharded = _repro()
    with JSharded.from_corpus(JFused(V, 0.6, 0.4), jc, 3, cand_qty=30, final_qty=10) as jpipe:
        jwant = jpipe.run(jq)
    np.testing.assert_array_equal(np.stack([r.indices for r in rows]), np.asarray(jwant.indices))
    assert ep.backend == "cuda" and ep.n_batches == 2
    pipe.close()


# ---- placement over a 4-rank DeviceMesh (gloo ranks) ------------------------------------------

MESH_SHARDS = (2, 3, 5, 8)
TIE_N, TIE_SHARDS, TIE_K = 64, 8, 20     # 8 shards over 4 slots: rank c holds shards c and c + 4


def _mesh_body(rank, world, fused_np, tie_np, q_tie):
    from repro_torch import interop
    from repro_torch.distributed import ParallelCtx, local_mesh

    mesh = local_mesh(("data", "model"), device="cpu")
    (cd, ci, cv), (qd, qi, qv) = fused_np
    corpus = interop.fused_vectors(cd, ci, cv, device="cpu")
    queries = interop.fused_vectors(qd, qi, qv, device="cpu")
    out = {"rank": rank}
    for rules, name in (({"corpus": "model"}, "model"), ({}, "flat")):
        ctx = ParallelCtx(mesh, rules)
        for n_shards in MESH_SHARDS:
            for backend in ("cuda", None):
                with ShardedPipeline.from_corpus(DenseSpace("ip"), corpus.dense, n_shards, ctx=ctx, axis="corpus",
                                                 backend=backend, cand_qty=20, final_qty=10) as pipe:
                    got = pipe.run(queries.dense)
                    held = [i for i, s in enumerate(pipe.shards) if s.corpus is not None]
                    views = all(s.corpus.data_ptr() == corpus.dense[s.offset].data_ptr()
                                for s in pipe.shards if s.corpus is not None)
                    out[name, n_shards, backend] = (got.scores.numpy(), got.indices.numpy(), held, views,
                                                    [(s.offset, s.n_rows) for s in pipe.shards])
        with ShardedPipeline.from_corpus(FusedSpace(V, 0.6, 0.4), corpus, 3, ctx=ctx, backend="cuda",
                                         cand_qty=30, final_qty=10) as pipe:
            got = pipe.run(queries)
            out[name, "fused"] = (got.scores.numpy(), got.indices.numpy())
    ctx = ParallelCtx(mesh, {"corpus": "model"})
    with ShardedPipeline.from_corpus(DenseSpace("ip"), torch.from_numpy(tie_np), TIE_SHARDS, ctx=ctx,
                                     backend="cuda", cand_qty=TIE_K, final_qty=TIE_K) as pipe:
        got = pipe.generate(torch.from_numpy(q_tie), TIE_K)
        out["tie"] = (got.scores.numpy(), got.indices.numpy())
    return out


def _tie_data():
    """Every row equal: every score ties, and the answer is rows 0..k-1 in
    row order.  Merged in rank order it would take shard 4 before shard 1."""
    rng = np.random.default_rng(5)
    row = rng.standard_normal(16).astype(np.float32)
    return np.tile(row, (TIE_N, 1)), rng.standard_normal((3, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    fused_np = planted_fused_np(N, V, NNZ, DD, B, 10, seed=11)
    return run_ranks(_mesh_body, 4, tmp_path_factory.mktemp("mesh"), fused_np, *_tie_data())


@pytest.mark.parametrize("rules", ["model", "flat"])
@pytest.mark.parametrize("n_shards", MESH_SHARDS)
def test_mesh_placement_via_parallel_ctx(fused, mesh_ranks, n_shards, rules):
    """``test_sharded.py::test_mesh_placement_via_parallel_ctx`` at 2, 3, 5
    and 8 shards: rank c holds the shards i with i % 4 == c (the model axis
    is the 4-rank axis, and so is the flat order of a (1, 4) mesh), each a
    view of its rows; every rank answers as ``repro``'s unsharded pipeline
    does."""
    from repro.core.pipeline import BruteForceGenerator, RetrievalPipeline
    from repro.core.spaces import DenseSpace as JDense

    jc, jq, _, _ = fused
    want = RetrievalPipeline(BruteForceGenerator(JDense("ip"), jc.dense), cand_qty=20, final_qty=10).run(jq.dense)
    bounds = [N * i // n_shards for i in range(n_shards + 1)]
    for r in mesh_ranks:
        for backend in ("cuda", None):
            scores, ids, held, views, layout = r[rules, n_shards, backend]
            assert held == [i for i in range(n_shards) if i % 4 == r["rank"]]
            assert views and layout == [(lo, hi - lo) for lo, hi in zip(bounds, bounds[1:])]
            assert_topk_match(want, type(want)(torch.from_numpy(scores), torch.from_numpy(ids)),
                              ctx=f"rank {r['rank']}, {n_shards} shards, {backend}")
            assert np.array_equal(ids, mesh_ranks[0][rules, n_shards, "cuda"][1])
            assert np.array_equal(scores.view(np.int32), mesh_ranks[0][rules, n_shards, "cuda"][0].view(np.int32))


@pytest.mark.parametrize("rules", ["model", "flat"])
def test_mesh_fused_equals_repro(fused, mesh_ranks, rules):
    jc, jq, _, _ = fused
    JFused, JSharded = _repro()
    with JSharded.from_corpus(JFused(V, 0.6, 0.4), jc, 3, cand_qty=30, final_qty=10) as jpipe:
        want = jpipe.run(jq)
    for r in mesh_ranks:
        scores, ids = r[rules, "fused"]
        assert_topk_match(want, type(want)(torch.from_numpy(scores), torch.from_numpy(ids)), ctx=f"rank {r['rank']}")


def test_mesh_merge_breaks_ties_in_shard_order(mesh_ranks):
    """More shards than slots, every score tied: the merge goes in shard
    (global row) order, so the answer is rows 0..k-1 as ``repro``'s is."""
    import jax.numpy as jnp

    from repro.core.pipeline import BruteForceGenerator
    from repro.core.spaces import DenseSpace as JDense

    corpus, q = _tie_data()
    want = BruteForceGenerator(JDense("ip"), jnp.asarray(corpus)).generate(jnp.asarray(q), TIE_K)
    assert np.array_equal(np.asarray(want.indices), np.tile(np.arange(TIE_K), (3, 1)))
    for r in mesh_ranks:
        scores, ids = r["tie"]
        assert np.array_equal(ids, np.asarray(want.indices)), r["rank"]
        assert np.array_equal(scores, np.asarray(want.scores))
