"""repro_torch.core.model1 held against repro.core.model1: the EM step (with
and without row blocks), training, and the log-probability feature.

The expected counts are an f32 sum over (pair, query token, doc token)
whose order differs between the reference's XLA scatter and the port's
accumulating ``index_put_`` (atomics on the card), and every later
iteration starts from the previous table, so tables are held within
``TABLE_RTOL`` = 1e-5 relative to each column's largest entry and the
log-likelihoods within ``LL_RTOL`` = 1e-5 relative (a mean of logs of
those sums).  Log-probabilities from one table (the reference's, carried
over) within 1e-5 of the row scale (``test_torch_scorers.LOG_RTOL``:
``log`` is not correctly rounded in either library).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model1 as jm
from repro.data.synthetic import make_bitext, make_corpus
from repro_torch.core import model1 as tm

from _torch_parity import assert_scores_close

pytestmark = pytest.mark.torch

TABLE_RTOL = 1e-5
LL_RTOL = 1e-5


@pytest.fixture(scope="module")
def bitext():
    """(query, relevant-doc chunk) pairs of the smoke config's corpus."""
    corpus = make_corpus(n_docs=256, n_queries=32, vocab_lemmas=500, seed=2)
    q, d, vocab = make_bitext(corpus, field="lemmas", max_q=8, max_d=16, chunk=16)
    return q, d, vocab


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_table_close(want, got):
    want, got = np.asarray(want, np.float64), got.numpy().astype(np.float64)
    scale = np.abs(want).max(0, keepdims=True)
    assert np.all(np.abs(got - want) <= TABLE_RTOL * scale), \
        float(np.max(np.abs(got - want) / scale))


def test_init_ttable_matches_repro():
    got = tm.init_ttable(7, 5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.init_ttable(7, 5)))


@pytest.mark.parametrize("batch_block", [0, 4, 7])
def test_em_step_matches_repro(bitext, batch_block):
    """One step from a random table; ``batch_block`` 4 divides the pairs
    (the reference scans row blocks), 7 does not (one block)."""
    q, d, v = bitext
    q, d = q[:64], d[:64]
    rng = np.random.default_rng(0)
    t0 = rng.random((v, v)).astype(np.float32) + 0.01
    t0 /= t0.sum(0, keepdims=True)
    want_t, want_ll = jm.em_step(jnp.asarray(t0), jnp.asarray(q), jnp.asarray(d), 1e-6, batch_block)
    got_t, got_ll = tm.em_step(_t(t0), _t(q), _t(d), 1e-6, batch_block)
    _assert_table_close(want_t, got_t)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=LL_RTOL)


@pytest.mark.parametrize("batch_block", [0, 16])
def test_train_model1_matches_repro(bitext, batch_block):
    q, d, v = bitext
    n = q.shape[0] // 16 * 16
    want_t, want_ll = jm.train_model1(jnp.asarray(q[:n]), jnp.asarray(d[:n]), v, v, iters=4,
                                      batch_block=batch_block)
    got_t, got_ll = tm.train_model1(_t(q[:n]), _t(d[:n]), v, v, iters=4, batch_block=batch_block)
    _assert_table_close(want_t, got_t)
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll), rtol=LL_RTOL)
    assert got_ll.dtype == torch.float32 and got_ll.shape == (4,)


def test_em_likelihood_rises_and_columns_sum_to_one(bitext):
    q, d, v = bitext
    t, lls = tm.train_model1(_t(q), _t(d), v, v, iters=5)
    lls = lls.tolist()
    assert all(lls[i + 1] >= lls[i] - 1e-4 for i in range(len(lls) - 1)), lls
    np.testing.assert_allclose(t.sum(0).numpy(), 1.0, atol=1e-5)


def test_rectangular_tables_and_padding_match_repro():
    """Vq != Vd, with pad ids at and past each vocabulary."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 14, (24, 5)).astype(np.int32)      # vq = 12: 12, 13 are padding
    d = rng.integers(0, 20, (24, 7)).astype(np.int32)      # vd = 18: 18, 19 are padding
    want_t, want_ll = jm.train_model1(jnp.asarray(q), jnp.asarray(d), 12, 18, iters=3)
    got_t, got_ll = tm.train_model1(_t(q), _t(d), 12, 18, iters=3)
    _assert_table_close(want_t, got_t)
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(want_ll), rtol=LL_RTOL)


@pytest.mark.parametrize("lam", [0.1, 0.7])
def test_model1_logprob_matches_repro(bitext, lam):
    q, d, v = bitext
    t, _ = jm.train_model1(jnp.asarray(q), jnp.asarray(d), v, v, iters=2)
    bg = np.random.default_rng(1).random(v).astype(np.float32)
    bg /= bg.sum()
    d_len = (d < v).sum(1).astype(np.int32)
    d_len[:3] = 0                                           # empty documents clamp to 1
    want = np.asarray(jm.model1_logprob(t, jnp.asarray(bg), jnp.asarray(q), jnp.asarray(d),
                                        jnp.asarray(d_len), v, lam))
    got = tm.model1_logprob(_t(np.asarray(t)), _t(bg), _t(q), _t(d), _t(d_len), v, lam).numpy()
    assert_scores_close(want[None], got[None], rtol=1e-5)


def test_model1_bridges_the_vocabulary_gap():
    """The reference's synonym bitext: a doc holding only the synonym
    outscores an unrelated doc after EM."""
    v = 20
    q = torch.tensor([[t] * 4 for t in range(10) for _ in range(8)], dtype=torch.int32)
    d = torch.tensor([[t + 10] * 6 for t in range(10) for _ in range(8)], dtype=torch.int32)
    tt, _ = tm.train_model1(q, d, v, v, iters=8)
    bg = torch.full((v,), 1.0 / v)
    q_test = torch.tensor([[3, 3, 3, 3]], dtype=torch.int32)
    six = torch.tensor([6], dtype=torch.int32)
    syn = tm.model1_logprob(tt, bg, q_test, torch.full((1, 6), 13, dtype=torch.int32), six, v)
    other = tm.model1_logprob(tt, bg, q_test, torch.full((1, 6), 17, dtype=torch.int32), six, v)
    assert float(syn[0]) > float(other[0])
