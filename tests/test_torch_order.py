"""The port's exact paths order scores as ``lax.top_k`` does (port faults
C5 and C6): the total order of the f32 bit patterns, so +0 ranks above -0
and a NaN by its bits (one with the sign bit set, which an x86 CPU makes
of 0 * inf, below -inf), ties toward the lower row.

The port's ``reference``, ``streaming`` and ``cuda`` backends (the last on
CPU tensors runs the kernels' plain versions, through ``topk_large`` for
k above ``MAX_K``) are held against repro's reference backend on corpora
of small integers whose rows score NaN, +0 and -0 exactly: one COO slot a
row, so that a sparse score is one product (values of both signs, and
of +-0, give both zeros; +inf at a term no query weighs gives NaN), rows
equal to a query (-0 in l2), zero dense rows (+0 in ip).  Ids must be
equal and scores equal bit for bit.  (A sum of -0 products is -0 in
repro's CPU dots and +0 in PyTorch's and the kernels', and repro's
two-part mix never gives -0: the corpora keep to zeros that both
frameworks compute alike.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core.sparse import SparseVectors as JSparse
from repro.core.spaces import DenseSpace as JDense
from repro.core.spaces import FusedSpace as JFused
from repro.core.spaces import FusedVectors as JFV
from repro.core.spaces import SparseSpace as JSparseSpace
from repro_torch.core import backends as tb
from repro_torch.core.brute_force import order_keys, select_topk
from repro_torch.core.spaces import DenseSpace, FusedSpace, SparseSpace
from repro_torch.kernels.mips_topk import MAX_K

from _torch_parity import fused_to_torch, np_of, sparse_to_torch, to_torch

pytestmark = pytest.mark.torch

V = 12   # vocabulary; queries weigh terms 0-3 only


def _corpus(n, seed):
    """Small-integer dense rows (a third of them zero) and one COO slot a
    row, of value -2, -1, -0, +0, 1, 2 or +inf at a random term; queries
    with dense values 1 or 2 and weights 1 or 2 on terms 0-3.  A row's
    sparse score is one product: +-0 from a zero value or a signed value
    at a term the query does not weigh, NaN from +inf there."""
    rng = np.random.default_rng(seed)
    cd = rng.integers(-1, 2, (n, 4)).astype(np.float32)
    cd[rng.uniform(size=n) < 0.35] = 0.0
    ci = rng.integers(0, V, (n, 1)).astype(np.int32)
    cv = rng.choice(np.array([-2, -1, -0.0, 0.0, 1, 2, np.inf], np.float32), (n, 1))
    qd = rng.integers(1, 3, (3, 4)).astype(np.float32)
    qi = np.tile(np.arange(4, dtype=np.int32), (3, 1))
    qv = rng.integers(1, 3, (3, 4)).astype(np.float32)
    return (cd, ci, cv), (qd, qi, qv)


def _pair(space, n, seed):
    (cd, ci, cv), (qd, qi, qv) = _corpus(n, seed)
    jc = JFV(jnp.asarray(cd), JSparse(jnp.asarray(ci), jnp.asarray(cv)))
    jq = JFV(jnp.asarray(qd), JSparse(jnp.asarray(qi), jnp.asarray(qv)))
    tc, tq = fused_to_torch(jc), fused_to_torch(jq)
    if space == "fused":
        return JFused(V, 0.5, 0.25), jq, jc, FusedSpace(V, 0.5, 0.25), tq, tc
    if space == "sparse":
        return (JSparseSpace(V), jq.sparse, jc.sparse, SparseSpace(V),
                sparse_to_torch(jq.sparse), sparse_to_torch(jc.sparse))
    kind = "ip" if space == "dense ip" else "l2"
    if kind == "l2":   # rows equal to a query score -0
        jc = JFV(jc.dense.at[5::11].set(jq.dense[0]), jc.sparse)
        tc = fused_to_torch(jc)
    return JDense(kind), jq.dense, jc.dense, DenseSpace(kind), to_torch(np_of(jq.dense)), tc.dense


@pytest.mark.parametrize("backend", ["reference", "streaming", "cuda"])
@pytest.mark.parametrize("space", ["fused", "sparse", "dense ip", "dense l2"])
@pytest.mark.parametrize("n,k", [(64, 64), (64, 23), (2304, 2100)])
def test_exact_backends_order_nan_and_signed_zeros_as_repro(backend, space, n, k):
    js, jq, jc, ts, tq, tc = _pair(space, n, seed=n + k)
    full = np.asarray(js.score_batch(jq, jc))   # the case is what it claims to be
    zero_signs = set(np.signbit(full[full == 0]).tolist())
    assert zero_signs == {"sparse": {False, True}, "fused": {False}, "dense ip": {False},
                          "dense l2": {True}}[space]
    assert np.isnan(full).any() == (space in ("sparse", "fused"))
    want = jb.ReferenceBackend().topk(js, jq, jc, k)
    ws = np.asarray(want.scores)
    be = {"reference": tb.ReferenceBackend(), "streaming": tb.StreamingBackend(tile_n=16),
          "cuda": tb.CudaBackend()}[backend]
    got = be.topk(ts, tq, tc, k)
    np.testing.assert_array_equal(np.asarray(want.indices), got.indices.numpy(),
                                  err_msg=f"{backend} {space} k={k}")
    np.testing.assert_array_equal(ws.view(np.uint32), got.scores.numpy().view(np.uint32))
    if backend == "cuda" and n == 2304:
        assert k > MAX_K   # served by topk_large's plain version


@pytest.mark.parametrize("seed", range(4))
def test_select_topk_orders_bit_patterns_as_lax_top_k(seed):
    """Random f32 bit patterns (every NaN payload and sign, denormals,
    +-0, +-inf) and many repeats: ``select_topk`` gives ``lax.top_k``'s
    ids and values, and ``order_keys`` is monotone in that order."""
    import jax

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    pool[:12] = [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                 0x7FFFFFFF, 0xFFFFFFFF, 1, 0x80000001, 0x3F800000, 0xBF800000]
    s = pool[rng.integers(0, 64, (4, 300))].view(np.float32)
    for k in (1, 17, 300):
        want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
        got_s, got_i = select_topk(torch.from_numpy(s.copy()), k)
        np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
        np.testing.assert_array_equal(np.asarray(want_s).view(np.uint32), got_s.numpy().view(np.uint32))
    keys = order_keys(torch.from_numpy(s.copy())).numpy()
    _, rank = jax.lax.top_k(jnp.asarray(s), 300)
    ranked = np.take_along_axis(keys, np.asarray(rank), 1)
    assert (np.diff(ranked.astype(np.int64), axis=1) <= 0).all()
