"""repro_torch.data on the CPU: the synthetic corpus, the bitext, the
graded labels, the neighbour sampler and the LM batches equal to
``repro``'s arrays for the same seeds (the port's copies are numpy only);
``pad_tokens``; ``device_put_batch`` and the ``Prefetcher`` deliver the
batches in order as tensors on the asked device.
"""

import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.data import sampler as JS
from repro.data import synthetic as JSY
from repro_torch.data import pipeline as TP
from repro_torch.data import sampler as TS
from repro_torch.data import synthetic as TSY

pytestmark = pytest.mark.torch


def assert_equal_arrays(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape, ctx)
    np.testing.assert_array_equal(a, b, err_msg=ctx)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_corpus_equals_repro(seed):
    kw = dict(n_docs=120, n_queries=20, n_topics=6, vocab_lemmas=300, seed=seed)
    want, got = JSY.make_corpus(**kw), TSY.make_corpus(**kw)
    for field in ("doc_tokens", "doc_lemmas", "doc_bert", "q_tokens", "q_lemmas", "q_bert"):
        w, g = getattr(want, field), getattr(got, field)
        assert len(w) == len(g)
        for i, (a, b) in enumerate(zip(w, g)):
            assert_equal_arrays(a, b, f"{field}[{i}]")
    assert_equal_arrays(want.doc_topic, got.doc_topic)
    assert_equal_arrays(want.synonym_map, got.synonym_map)
    assert want.qrels == got.qrels
    assert (want.vocab_tokens, want.vocab_lemmas, want.vocab_bert, want.n_variants) == \
        (got.vocab_tokens, got.vocab_lemmas, got.vocab_bert, got.n_variants)
    cand = np.random.default_rng(seed).integers(0, 120, (20, 7))
    assert_equal_arrays(JSY.qrels_to_labels(want, cand), TSY.qrels_to_labels(got, cand))
    for field in ("tokens", "lemmas", "bert"):
        for a, b in zip(JSY.make_bitext(want, field, seed=seed), TSY.make_bitext(got, field, seed=seed)):
            assert_equal_arrays(a, b, field)


@pytest.mark.parametrize("fanout", [(4,), (3, 2), (10, 5)])
def test_sampler_equals_repro(fanout):
    """CSR from random edges, a sampled subgraph (degrees below, at and
    above the fanout, isolated nodes) and its padded form."""
    jg, tg = JS.CSRGraph.random(200, 4, seed=1), TS.CSRGraph.random(200, 4, seed=1)
    assert_equal_arrays(jg.indptr, tg.indptr)
    assert_equal_arrays(jg.indices, tg.indices)
    seeds = np.array([0, 5, 17, 199, 42], np.int64)
    js, ts = JS.sample_subgraph(jg, seeds, fanout, seed=2), TS.sample_subgraph(tg, seeds, fanout, seed=2)
    assert_equal_arrays(js.node_ids, ts.node_ids)
    assert js.seed_count == ts.seed_count and len(js.blocks) == len(ts.blocks)
    for a, b in zip(js.blocks, ts.blocks):
        for f in ("senders", "receivers", "edge_mask"):
            assert_equal_arrays(getattr(a, f), getattr(b, f), f)
    caps = [len(seeds) * int(np.prod(fanout[:i + 1])) for i in range(len(fanout))]
    for a, b in zip(JS.pad_subgraph(js, 1024, caps), TS.pad_subgraph(ts, 1024, caps)):
        assert_equal_arrays(a, b)


def test_lm_batches_and_pad_tokens_equal_repro():
    stream = np.random.default_rng(0).integers(0, 512, 5_000).astype(np.int32)
    jb, tb = JP.lm_batches(stream, 4, 33, seed=7), TP.lm_batches(stream, 4, 33, seed=7)
    for _ in range(5):
        a, b = next(jb), next(tb)
        assert list(a) == list(b) == ["tokens", "targets"]
        for k in a:
            assert_equal_arrays(a[k], b[k], k)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    rows = [[1, 2, 3], [], np.arange(9)]
    assert_equal_arrays(JP.pad_tokens(rows, 5, 0), TP.pad_tokens(rows, 5, 0))


def test_device_put_and_prefetcher_deliver_in_order():
    batches = [{"tokens": np.full((2, 3), i, np.int32), "targets": np.full((2, 3), -i, np.int32)}
               for i in range(5)]
    put = TP.device_put_batch(batches[0], "cpu")
    assert put["tokens"].device.type == "cpu" and put["tokens"].dtype == torch.int32
    got = list(TP.Prefetcher(iter(batches), device="cpu", depth=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert torch.equal(b["tokens"], torch.full((2, 3), i, dtype=torch.int32))
        assert torch.equal(b["targets"], torch.full((2, 3), -i, dtype=torch.int32))


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.device_put_batch({"tokens": np.zeros(2, np.int32)})
