"""repro_torch backends and pipeline held against repro, and the slice end
to end: mixing weights learned by ``repro.core.fusion.learn_fused_weights``
carried across by ``interop`` into ``RetrievalPipeline`` on the ``cuda``
backend (its plain path on the CPU), against repro's pipeline on the
``pallas`` backend (interpret mode).

Tolerances: ids equal; f32 scores within ``F32_RTOL`` (2e-6) of the row's
largest |score|; -inf tails equal exactly; bf16 corpora also at recall@k
== 1.0 and ``BF16_MAX_ULP`` against the f32 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core import pipeline as jp
from repro.core.fusion import learn_fused_weights
from repro.core.fusion import topk_recall as j_recall
from repro.core.spaces import DenseSpace as JDense
from repro.core.spaces import FusedSpace as JFused
from repro.core.spaces import FusedVectors as JFV
from repro.core.spaces import SparseSpace as JSparseSpace
from repro_torch import interop
from repro_torch.core import backends as tb
from repro_torch.core import pipeline as tp
from repro_torch.core.brute_force import TopK
from repro_torch.core.fusion import topk_recall
from repro_torch.core.spaces import DenseSpace, FusedSpace, FusedVectors, SparseSpace

from _precision import assert_bf16_oracle_contract, planted_margin_corpus
from _torch_parity import (assert_topk_match, fused_to_torch, jnp_fused,
                           planted_fused_np, sparse_to_torch, to_torch)

pytestmark = pytest.mark.torch


def _pairs():
    """(repro space, repro corpus, port space, port corpus) over the
    capability matrix: inside and outside it."""
    (cd, ci, cv), _ = planted_fused_np(40, 20, 4, 6, 2, 3)
    jf = jnp_fused((cd, ci, cv))
    tf = fused_to_torch(jf)
    jf16 = JFV(jf.dense.astype(jnp.float16), jf.sparse)
    tf16 = FusedVectors(tf.dense.half(), tf.sparse)
    jbf = JFV(jf.dense.astype(jnp.bfloat16), jf.sparse)
    tbf = FusedVectors(tf.dense.bfloat16(), tf.sparse)
    out = []
    for kind in ("ip", "l2", "cosine"):
        for jd, td in ((jf.dense, tf.dense), (jbf.dense, tbf.dense), (jf16.dense, tf16.dense)):
            out.append((JDense(kind), jd, DenseSpace(kind), td))
        out.append((JFused(20, dense_kind=kind), jf, FusedSpace(20, dense_kind=kind), tf))
        out.append((JFused(20, dense_kind=kind), jbf, FusedSpace(20, dense_kind=kind), tbf))
    for kind in ("ip", "cosine"):
        out.append((JSparseSpace(20, kind), jf.sparse, SparseSpace(20, kind), tf.sparse))
    out += [
        (JFused(20), jf16, FusedSpace(20), tf16),
        (JFused(20), JFV(None, None), FusedSpace(20), FusedVectors(None, None)),
        (JFused(20), jf.dense, FusedSpace(20), tf.dense),
        (JSparseSpace(20), jf, SparseSpace(20), tf),
        (JDense(), jf, DenseSpace(), tf),
        (JFused(20), JFV(None, jf.sparse), FusedSpace(20), FusedVectors(None, tf.sparse)),
    ]
    return out


def test_supports_matrix_equals_pallas():
    for js, jc, ts, tc in _pairs():
        want = jb.PallasBackend().supports(js, jc) is None
        assert (tb.CudaBackend().supports(ts, tc) is None) == want, (ts, want)
        resolved = tb.resolve_backend("cuda", ts, tc)
        assert isinstance(resolved, tb.CudaBackend if want else tb.ReferenceBackend)
        assert tb.backend_identity(resolved) == ("cuda" if want else "reference")


def test_registry_and_names():
    assert isinstance(tb.make_backend("pallas"), tb.CudaBackend)   # repro descriptors
    assert set(tb.available_backends()) == {"cuda", "graph_ann", "napp", "pallas",
                                            "reference", "streaming"}
    assert set(tb.available_backends()) - {"cuda"} == set(jb.available_backends())
    assert tb.backend_identity(None) is None and tb.backend_identity("x") == "x"
    assert isinstance(tb.resolve_backend(tb.CudaBackend()), tb.CudaBackend)
    assert isinstance(tb.ReferenceBackend(), tb.ExecutionBackend)
    assert isinstance(tb.make_backend("streaming", tile_n=64), tb.StreamingBackend)
    with pytest.raises(ValueError, match="unknown backend"):
        tb.make_backend("exact")
    # "auto" and None resolve; without a corpus, as in repro, to reference
    assert isinstance(tb.resolve_backend("auto"), tb.ReferenceBackend)
    assert isinstance(tb.resolve_backend(None), tb.ReferenceBackend)
    assert isinstance(tb.resolve_backend(), tb.ReferenceBackend)
    assert tb.legal_tile(10, 64) == 10 and tb.legal_tile(100, 64) == 64


def _auto_corpora(n):
    """(name, repro space, repro corpus, port space, port corpus) with n
    rows: dense ip, sparse ip, fused ip, and spaces the kernel refuses."""
    rng = np.random.default_rng(n)
    d = rng.normal(size=(n, 4)).astype(np.float32)
    i = rng.integers(0, 20, size=(n, 2)).astype(np.int32)
    v = rng.uniform(size=(n, 2)).astype(np.float32)
    jc = jnp_fused((d, i, v))
    tc = fused_to_torch(jc)
    return [("dense", JDense("ip"), jc.dense, DenseSpace("ip"), tc.dense),
            ("dense-cosine", JDense("cosine"), jc.dense, DenseSpace("cosine"), tc.dense),
            ("sparse", JSparseSpace(20), jc.sparse, SparseSpace(20), tc.sparse),
            ("sparse-cosine", JSparseSpace(20, "cosine"), jc.sparse, SparseSpace(20, "cosine"),
             tc.sparse),
            ("fused", JFused(20, 0.3, 0.7), jc, FusedSpace(20, 0.3, 0.7), tc),
            ("fused-l2", JFused(20, dense_kind="l2"), jc, FusedSpace(20, dense_kind="l2"), tc)]


@pytest.mark.parametrize("n", [100, 4096, 20_000, 32_768, 40_000])
def test_auto_matches_repro(n):
    """``"auto"`` picks the same kind of backend as repro's ``_auto`` off
    the card (repro off a TPU), below and above both thresholds; the
    kernel backend is ``pallas`` there, ``cuda`` here."""
    kinds = {jb.PallasBackend: tb.CudaBackend, jb.StreamingBackend: tb.StreamingBackend,
             jb.ReferenceBackend: tb.ReferenceBackend}
    for name, js, jc, ts, tc in _auto_corpora(n):
        want = jb.resolve_backend("auto", js, jc)
        got = tb.resolve_backend("auto", ts, tc)
        assert type(got) is kinds[type(want)], (name, n, want, got)
        assert type(tb.resolve_backend(None, ts, tc)) is type(got)
        if isinstance(got, tb.StreamingBackend):
            assert got.identity == want.identity
            assert tb.resolve_backend("auto", ts, tc, tile_n=512).identity == "streaming(tile_n=512)"
    assert tb.AUTO_PALLAS_MIN_ROWS == jb.AUTO_PALLAS_MIN_ROWS
    assert tb.AUTO_STREAMING_MIN_ROWS == jb.AUTO_STREAMING_MIN_ROWS


def test_auto_never_picks_ann_and_refuses_opaque_corpora():
    for _, _, _, ts, tc in _auto_corpora(40_000):
        assert tb.resolve_backend("auto", ts, tc).name in ("reference", "streaming", "cuda")
    assert isinstance(tb.resolve_backend("auto", DenseSpace(), [1, 2]), tb.ReferenceBackend)


# (n, tile, k, n_valid): ragged N, n_valid < N, k > n_valid, k = 0 valid rows
STREAM_CASES = [(203, 64, 5, None), (203, 64, 12, 150), (100, 256, 20, 7), (64, 16, 3, 0),
                (96, 32, 96, None)]


@pytest.mark.parametrize("space", ["dense", "fused", "sparse"])
@pytest.mark.parametrize("case", STREAM_CASES)
def test_streaming_matches_repro(space, case):
    n, tile, k, n_valid = case
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(n, 30, 6, 8, 3, min(k, n // 2) or 1,
                                                  seed=n, dups=(5, 9))
    jc, jq = jnp_fused((cd, ci, cv)), jnp_fused((qd, qi, qv))
    js, ts = JFused(30, 0.6, 0.4), FusedSpace(30, 0.6, 0.4)
    tc, tq = fused_to_torch(jc), fused_to_torch(jq)
    if space == "dense":
        jc, jq, tc, tq, js, ts = jc.dense, jq.dense, tc.dense, tq.dense, JDense(), DenseSpace()
    elif space == "sparse":
        jc, jq, tc, tq = jc.sparse, jq.sparse, tc.sparse, tq.sparse
        js, ts = JSparseSpace(30), SparseSpace(30)
    want = jb.StreamingBackend(tile_n=tile).topk(js, jq, jc, k, n_valid)
    got = tb.StreamingBackend(tile_n=tile).topk(ts, tq, tc, k, n_valid)
    assert got.indices.dtype == torch.int32 and got.scores.shape == (3, k)
    assert_topk_match(want, got, ctx=(space, case))
    assert_topk_match(jb.ReferenceBackend().topk(js, jq, jc, k, n_valid), got, ctx=(space, case))


def test_streaming_topk_and_generator():
    q, c, _ = planted_margin_corpus(256, 8, 3, 4, seed=4)
    from repro.core.brute_force import streaming_topk as j_streaming
    from repro_torch.core.brute_force import streaming_topk as t_streaming

    want = j_streaming(JDense(), q, c, 7, tile_n=64, n_valid=200)
    got = t_streaming(DenseSpace(), to_torch(q), to_torch(c), 7, tile_n=64, n_valid=200)
    assert_topk_match(want, got)
    with pytest.raises(ValueError, match="multiple of tile_n"):
        t_streaming(DenseSpace(), to_torch(q), to_torch(c), 7, tile_n=100)
    jgen = jp.StreamingGenerator(JDense(), c, tile_n=48, n_valid=250)
    tgen = tp.StreamingGenerator(DenseSpace(), to_torch(c), tile_n=48, n_valid=250)
    assert tgen.corpus_dtype == jgen.corpus_dtype == "float32"
    assert_topk_match(jgen.generate(q, 6), tgen.generate(to_torch(q), 6))
    assert tgen.with_backend("streaming").backend.identity == "streaming(tile_n=48)"
    assert isinstance(tgen.with_backend("cuda").backend, tb.CudaBackend)
    assert isinstance(tgen.with_backend("auto").backend, tb.ReferenceBackend)   # 256 rows
    bf = tgen.with_corpus_dtype("bf16")
    assert bf.corpus_dtype == "bfloat16" and bf.corpus.dtype == torch.bfloat16
    pipe = tp.RetrievalPipeline(tgen, cand_qty=6, final_qty=2)
    assert_topk_match(jp.RetrievalPipeline(jgen, cand_qty=6, final_qty=2).run(q),
                      pipe.run(to_torch(q)))


@pytest.mark.parametrize("k,n_valid", [(12, 7), (5, 0), (40, 40), (3, None)])
def test_dense_tail_matches_repro(k, n_valid):
    q, c, _ = planted_margin_corpus(40, 8, 3, 4, seed=3)
    want = jb.PallasBackend().topk(JDense("ip"), q, c, k, n_valid)
    ref = jb.ReferenceBackend().topk(JDense("ip"), q, c, k, n_valid)
    got = tb.CudaBackend().topk(DenseSpace("ip"), to_torch(q), to_torch(c), k, n_valid)
    assert got.scores.shape == (3, k) and got.indices.dtype == torch.int32
    assert_topk_match(want, got, ctx=(k, n_valid))
    assert_topk_match(ref, got, ctx=(k, n_valid))


@pytest.mark.parametrize("space", ["fused", "sparse"])
def test_fused_tail_matches_repro(space):
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(64, 30, 6, 8, 2, 4, seed=5)
    jc, jq = jnp_fused((cd, ci, cv)), jnp_fused((qd, qi, qv))
    js, ts = JFused(30, 0.6, 0.4), FusedSpace(30, 0.6, 0.4)
    if space == "sparse":
        jc, jq, js, ts = jc.sparse, jq.sparse, JSparseSpace(30), SparseSpace(30)
    tc = fused_to_torch(jc) if space == "fused" else sparse_to_torch(jc)
    tq = fused_to_torch(jq) if space == "fused" else sparse_to_torch(jq)
    for k, n_valid in [(10, 6), (4, None)]:
        want = jb.PallasBackend().topk(js, jq, jc, k, n_valid)
        got = tb.CudaBackend().topk(ts, tq, tc, k, n_valid)
        assert_topk_match(want, got, ctx=(space, k, n_valid))


@pytest.mark.parametrize("space", ["dense", "fused", "dense-l2", "sparse"])
def test_cuda_backend_serves_k_above_max_k(space, monkeypatch):
    """k = 2100 > MAX_K (2048) on N = 3000: the cuda backend answers as
    repro's reference backend does; the scan kernels' wrappers never see a
    k above MAX_K, and the large-k wrapper (``kernels.topk_large``) serves
    it."""
    from repro_torch.kernels import fused_topk as fk
    from repro_torch.kernels import mips_topk as mk
    from repro_torch.kernels import topk_large as lk

    seen = {}
    for mod, name, k_at in ((mk, "mips_topk", 2), (fk, "fused_topk", 5), (lk, "topk_large", 5)):
        real = getattr(mod, name)

        def spy(*a, real=real, k_at=k_at, name=name, **kw):
            seen.setdefault(name, []).append(a[k_at])
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    n, k = 3000, 2100
    assert k > mk.MAX_K
    if space.startswith("dense"):
        kind = "l2" if space == "dense-l2" else "ip"
        q, c, planted = planted_margin_corpus(n, 16, 3, k, seed=7)
        js, ts, jq, jc, tq, tc = JDense(kind), DenseSpace(kind), q, c, to_torch(q), to_torch(c)
    else:
        (cd, ci, cv), (qd, qi, qv) = planted_fused_np(n, 40, 6, 8, 3, 16, seed=8)
        jc, jq = jnp_fused((cd, ci, cv)), jnp_fused((qd, qi, qv))
        js, ts, tq, tc = JFused(40, 0.6, 0.4), FusedSpace(40, 0.6, 0.4), fused_to_torch(jq), fused_to_torch(jc)
        if space == "sparse":
            jc, jq, js, ts = jc.sparse, jq.sparse, JSparseSpace(40), SparseSpace(40)
            tc, tq = sparse_to_torch(jc), sparse_to_torch(jq)
    want = jb.ReferenceBackend().topk(js, jq, jc, k)
    got = tb.CudaBackend().topk(ts, tq, tc, k)
    assert got.indices.shape == (3, k) and got.indices.dtype == torch.int32
    assert_topk_match(want, got, ctx=space)
    if space == "dense":
        assert set(np.asarray(got.indices)[0].tolist()) == set(np.asarray(planted).tolist())
    assert seen == {"topk_large": [k]}
    # at MAX_K the scan kernels' wrappers serve
    tb.CudaBackend().topk(ts, tq, tc, mk.MAX_K)
    assert seen == {"topk_large": [k], ("mips_topk" if space.startswith("dense") else "fused_topk"): [mk.MAX_K]}


def _learned_setup(n=300, v=50, nnz=8, dd=16, b=6, k=10):
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(n, v, nnz, dd, b, k, seed=11)
    jc, jq = jnp_fused((cd, ci, cv)), jnp_fused((qd, qi, qv))
    dense_s = np.asarray(JDense("ip").score_batch(jq.dense, jc.dense))
    sparse_s = np.asarray(JSparseSpace(v).score_batch(jq.sparse, jc.sparse))
    labels = (dense_s + sparse_s >= np.quantile(dense_s + sparse_s, 0.95, axis=1,
                                                keepdims=True)).astype(np.float32)
    wd, ws, metric = learn_fused_weights(
        jnp.asarray(dense_s), jnp.asarray(sparse_s), jnp.asarray(labels),
        jnp.ones(labels.shape, bool), n_rounds=2, n_restarts=1)
    assert metric > 0
    return jc, jq, JFused(v).with_weights(wd, ws), v


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_slice_end_to_end_with_learned_weights(dtype):
    jc, jq, jspace, v = _learned_setup()
    jpipe = jp.RetrievalPipeline(jp.BruteForceGenerator(jspace, jc, backend="pallas",
                                                        corpus_dtype=dtype),
                                 cand_qty=10, final_qty=5)
    space = interop.fused_space(jspace.vocab_size, jspace.w_dense, jspace.w_sparse,
                                jspace.dense_kind)
    tpipe = tp.RetrievalPipeline(tp.BruteForceGenerator(space, fused_to_torch(jc),
                                                        backend="cuda", corpus_dtype=dtype),
                                 cand_qty=10, final_qty=5)
    tq = fused_to_torch(jq)
    got = tpipe.run(tq)
    assert got.scores.shape == (jq.dense.shape[0], 5)
    assert_topk_match(jpipe.run(jq), got)
    assert tpipe.corpus_dtype == jpipe.corpus_dtype
    cands = tpipe.generate_candidates(tq)
    assert_topk_match(jpipe.generate_candidates(jq), cands)
    if dtype:
        oracle = jp.RetrievalPipeline(jp.BruteForceGenerator(jspace, jc), cand_qty=10,
                                      final_qty=10).run(jq)
        assert_bf16_oracle_contract(oracle, cands)
    # the learned weights reach the scores: another mix changes them
    other = tp.BruteForceGenerator(space.with_weights(space.w_sparse, space.w_dense),
                                   fused_to_torch(jc), backend="cuda")
    if not np.isclose(space.w_dense, space.w_sparse):
        assert not torch.equal(other.generate(tq, 10).scores,
                               tp.BruteForceGenerator(space, fused_to_torch(jc)).generate(tq, 10).scores)


def test_generator_seams():
    jc, jq, jspace, v = _learned_setup(n=120, b=2)
    space = FusedSpace(v, jspace.w_dense, jspace.w_sparse)
    tc, tq = fused_to_torch(jc), fused_to_torch(jq)
    gen = tp.BruteForceGenerator(space, tc)
    assert gen.corpus_dtype == "float32"
    ref = gen.generate(tq, 8)
    cuda = gen.with_backend("pallas")
    assert isinstance(cuda.backend, tb.CudaBackend)
    assert_topk_match(ref, cuda.generate(tq, 8))
    bf = cuda.with_corpus_dtype("bf16")
    assert bf.corpus_dtype == "bfloat16" and isinstance(bf.backend, tb.CudaBackend)
    assert bf.corpus.dense.dtype == torch.bfloat16
    cos = tp.BruteForceGenerator(FusedSpace(v, dense_kind="cosine"), tc).with_backend("cuda")
    assert isinstance(cos.backend, tb.ReferenceBackend)        # capability fallback
    pipe = tp.RetrievalPipeline(gen, cand_qty=8, final_qty=3)
    assert isinstance(pipe.with_backend("cuda").backend, tb.CudaBackend)
    assert pipe.with_corpus_dtype("bf16").corpus_dtype == "bfloat16"
    with pytest.raises(TypeError):
        tp.RetrievalPipeline(object()).with_backend("cuda")


def test_apply_rerankers():
    cands = TopK(torch.tensor([[3.0, 2.0, 1.0]]), torch.tensor([[7, 8, 9]], dtype=torch.int32))
    kept = tp.apply_rerankers(cands, final_qty=2)
    assert kept.indices.tolist() == [[7, 8]]
    assert tp.apply_rerankers(cands, final_qty=10).indices.shape == (1, 3)

    class Reverse:
        def rerank(self, q_tokens, c, keep):
            return TopK(c.scores.flip(1)[:, :keep], c.indices.flip(1)[:, :keep])

    out = tp.apply_rerankers(cands, None, intermediate=Reverse(), final=Reverse(),
                             interm_qty=2, final_qty=1)
    assert out.indices.tolist() == [[8]]     # [9, 8] after the first, then [8]


def test_topk_recall_matches_repro():
    rng = np.random.default_rng(0)
    a = np.argsort(rng.uniform(size=(4, 20)), axis=1)[:, :5]    # distinct ids per row
    b = np.argsort(rng.uniform(size=(4, 20)), axis=1)[:, :5]
    assert topk_recall(a, b) == j_recall(a, b)
    assert topk_recall(torch.from_numpy(a), torch.from_numpy(a)) == 1.0
    assert topk_recall(a[0], a[0]) == 1.0
    with pytest.raises(ValueError):
        topk_recall(a, b[:2])
