"""repro_torch's large-k top-k (``kernels/topk_large.py``, the kernels
for k above the scan kernels' ``MAX_K``) on the CPU, its plain version,
held against ``repro.kernels.ref`` on small corpora up to k = n_valid;
and a numpy form of the selection kernels (radix passes, refinement,
ordered fill of tied rows, the final sort) held against ``lax.top_k``.

The CUDA kernels cannot run here; ``chip_smoke.py`` (phase "large small")
holds them against this plain version on the card.  Tolerances: ids
equal; f32 scores within ``F32_RTOL`` (2e-6) of the row's largest
|score|; selections of given scores bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import SparseVectors as JSparse
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_large as lk
from repro_torch.kernels.ref import query_table

from _precision import planted_margin_corpus
from _torch_parity import (assert_topk_match, planted_fused_np, sparse_to_torch,
                           to_torch)

pytestmark = pytest.mark.torch


@pytest.fixture
def no_library(monkeypatch):
    """Fail if anything tries to build or load the CUDA library."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = lk.launches
    yield
    assert lk.launches == before


@pytest.mark.parametrize("variant", ["fused", "dense", "sparse"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [6, 200])
def test_topk_large_matches_repro(variant, dtype, k, no_library):
    """Every valid row (k = n_valid = 200 of 203) and a planted head, in
    repro's order, for fused, weighted dense and unweighted sparse."""
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(203, 40, 6, 8, 3, 6, seed=203)
    c_dense = jnp.asarray(cd, dtype) if variant != "sparse" else None
    q_dense = jnp.asarray(qd, jnp.float32) if variant != "sparse" else None
    c_sp = JSparse(jnp.asarray(ci), jnp.asarray(cv, dtype)) if variant != "dense" else None
    q_sp = JSparse(jnp.asarray(qi), jnp.asarray(qv, jnp.float32)) if variant != "dense" else None
    wd, ws = {"fused": (0.6, 0.4), "dense": (0.7, None), "sparse": (None, None)}[variant]
    args = (q_sp, q_dense, c_sp, c_dense, 40, k)
    got = tops.topk_large(sparse_to_torch(q_sp), to_torch(q_dense), sparse_to_torch(c_sp),
                          to_torch(c_dense), 40, k, w_dense=wd, w_sparse=ws, n_valid=200)
    assert got.indices.shape == (3, k) and got.indices.dtype == torch.int32
    assert_topk_match(jref.fused_topk_ref(*args, w_dense=wd, w_sparse=ws, n_valid=200), got,
                      ctx=(variant, dtype, k))


@pytest.mark.parametrize("space,b", [pytest.param("ip", 3, id="ip"), pytest.param("l2", 3, id="l2"),
                                     ("ip", 64), ("l2", 64)])
def test_topk_large_dense_kinds_match_repro(space, b, no_library):
    """Every valid row in repro's order; at B = 64 the card launches the
    dense pass as clusters of 4 blocks over one read of the corpus."""
    q, c, planted = planted_margin_corpus(300, 16, b, 8, seed=5)
    got = tops.topk_large(None, to_torch(q), None, to_torch(c), 0, 290, dense_kind=space,
                          n_valid=290)
    assert got.indices.shape == (b, 290)
    assert_topk_match(jref.mips_topk_ref(q, c, 290, n_valid=290, space=space), got, ctx=space)
    if space == "ip":
        assert set(np.asarray(got.indices)[:, :8].ravel()) == set(np.asarray(planted).tolist())
    # the launch without clusters (a block a group) computes the same plain scores
    one = lk.topk_large(None, to_torch(q), None, None, to_torch(c), 290, n_valid=290, dense_kind=space,
                        cluster=False)
    assert torch.equal(one[1], got.indices) and torch.equal(one[0].view(torch.int32), got.scores.view(torch.int32))


def test_query_groups_layout():
    """The dense kernel reads query q's value of column c at [q // 16, c,
    q % 16]; columns up to a multiple of 32 and queries up to a multiple of
    16 are zero, and so are the groups a cluster grid adds past the batch
    (B = 129: two rows of clusters of 5 groups; B = 200: two of 7)."""
    for b, groups in ((19, None), (129, 10), (200, 14)):
        q = torch.from_numpy(np.random.default_rng(3).standard_normal((b, 40)).astype(np.float32))
        g = lk.query_groups(q, groups)
        want = -(-b // 16) if groups is None else groups
        assert g.shape == (want, 64, 16) and g.is_contiguous()
        if groups is not None:
            assert groups == lk.ring_grid(b, 132).padded
        for i, c in ((0, 0), (5, 39), (16, 7), (18, 33), (b - 1, 20)):
            assert g[i // 16, c, i % 16] == q[i, c]
        assert not g[:, 40:].any() and not g[b // 16, :, b % 16:].any() and not g[-(-b // 16):].any()


def test_topk_large_refusals(no_library):
    c = torch.zeros((10, 4))
    q = torch.zeros((2, 4))
    for k, n_valid in ((0, None), (11, None), (9, 8)):
        with pytest.raises(ValueError, match="outside 1..n_valid"):
            lk.topk_large(None, q, None, None, c, k, n_valid=n_valid)
    with pytest.raises(ValueError, match="no components"):
        lk.topk_large(None, None, None, None, None, 1)
    with pytest.raises(ValueError, match="sparse/fused ip"):
        lk.topk_large(q, q, torch.zeros((10, 2), dtype=torch.int32), torch.zeros((10, 2)), c, 1,
                      w_dense=1.0, w_sparse=1.0, dense_kind="l2")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        lk.topk_large(None, q.to("meta"), None, None, c.to("meta"), 1)


def _order_key(x):
    """``order_key`` of ``csrc/topk_scan.cuh``: uint32 keys in ``lax.top_k``'s
    order, the total order of the f32 bit patterns (+0 above -0, NaN by its
    bits)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)


LEVELS = ((20, 12), (10, 10), (0, 10))   # (shift, bits) of the selection's three passes


def _select(s, k, cap, rng=None, modes=None):
    """The selection kernels (``csrc/topk_large.cu``) for one query in
    numpy: up to three histogram passes over 12, 10 and 10 bits of the
    order keys, each over the rows matching the bits resolved so far, until
    the k-th key's bin holds at most ``cap`` rows (mode 1: collect every row
    above or in it) or all 32 bits are resolved (mode 2: the rows above, then
    the first ``need`` rows of the k-th key in row order); the list, in the
    atomic appends' arbitrary order, sorted by (key descending, row
    ascending), and its first k."""
    key = _order_key(s)
    need, above, prefix = k, 0, 0
    for level, (shift, bits) in enumerate(LEVELS):
        match = np.ones(key.size, bool) if level == 0 else (key >> LEVELS[level - 1][0]) == prefix
        hist = np.bincount((key[match] >> shift) & ((1 << bits) - 1), minlength=1 << bits)
        suffix = np.cumsum(hist[::-1])[::-1]          # rows in bins >= t
        t = int(np.flatnonzero(suffix >= need).max())
        above_here = int(suffix[t] - hist[t])
        prefix = t if level == 0 else (prefix << bits) | t
        need -= above_here
        above += above_here
        count = int(hist[t])
        mode = 1 if count <= cap else 2 if level == len(LEVELS) - 1 else 0
        if mode:
            break
    if modes is not None:
        modes.append((level, mode))
    top = key >> shift
    rows = np.flatnonzero(top > prefix)
    assert rows.size == above
    if mode == 1:
        rows = np.concatenate([rows, np.flatnonzero(top == prefix)])
        assert rows.size <= k - 1 + cap
    else:
        rows = np.concatenate([rows, np.flatnonzero(key == prefix)[:need]])
        assert rows.size == k
    if rng is not None:
        rows = rng.permutation(rows)
    order = np.lexsort((rows, -key[rows].astype(np.int64)))[:k]
    return s[rows[order]], rows[order]


def _scores(case, rng, n):
    s = rng.standard_normal(n).astype(np.float32)
    if case == "ties":
        s = np.round(s * 4).astype(np.float32) + np.float32(0.5)
    if case == "all equal":
        s = np.full(n, 0.25, np.float32)
    if case in ("extremes", "nan"):
        x = rng.uniform(size=n)
        s[x < 0.1] = np.inf
        s[(x >= 0.1) & (x < 0.2)] = -np.inf
        s[(x >= 0.2) & (x < 0.3)] = np.finfo(np.float32).min
        s[(x >= 0.3) & (x < 0.4)] = np.finfo(np.float32).max
    if case == "nan":   # both signs and two payloads: lax.top_k orders them by bits
        bits = np.array([0x7FC00000, 0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF], np.uint32).view(np.float32)
        pick = rng.uniform(size=n) < 0.1
        s[pick] = bits[rng.integers(0, 4, int(pick.sum()))]
    if case == "zeros":
        x = rng.uniform(size=n)
        s[x < 0.3] = 0.0
        s[(x >= 0.3) & (x < 0.6)] = -0.0
    return s


@pytest.mark.parametrize("case", ["normal", "ties", "extremes", "nan", "zeros", "all equal"])
def test_select_emulation_matches_lax_top_k(case):
    """The selection kernels' passes, refinement and tie fill give
    ``lax.top_k``'s top k, values bit for bit: ties on the k-th score
    (quantised scores), +-inf and f32-min, NaN of both signs and two
    payloads, +0 and -0, all-equal rows, at k from 1 to N = n_valid, with
    the real capacity and with small ones that force the refinement passes
    and the ordered fill of tied rows."""
    rng = np.random.default_rng(["normal", "ties", "extremes", "nan", "zeros", "all equal"].index(case))
    n = 3000
    s = _scores(case, rng, n)
    modes = []
    for k in (1, 7, 2049, 2100, n // 2, n):
        want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
        for cap in (lk.capacity(k), 64, 1):
            got_s, got_i = _select(s, k, cap, rng, modes)
            np.testing.assert_array_equal(np.asarray(want_i), got_i, err_msg=f"{case} k={k} cap={cap}")
            np.testing.assert_array_equal(np.asarray(want_s).view(np.uint32), got_s.view(np.uint32))
    assert any(level == 2 for level, _ in modes), modes        # every pass ran
    if case in ("ties", "zeros", "all equal"):
        assert any(mode == 2 for _, mode in modes), modes      # and the ordered fill


@pytest.mark.parametrize("case", ["nan", "zeros", "all equal"])
def test_select_large_plain_matches_lax_top_k(case, no_library):
    """``select_large`` on CPU scores (its plain version, ``select_topk``)
    gives ``lax.top_k``'s ids and values bit for bit, per row."""
    rng = np.random.default_rng(7)
    s = np.stack([_scores(case, rng, 500) for _ in range(3)])
    for k in (1, 250, 500):
        got_s, got_i = lk.select_large(torch.from_numpy(s), k)
        want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
        np.testing.assert_array_equal(np.asarray(want_s).view(np.uint32), got_s.numpy().view(np.uint32))


def test_large_scores_plain_is_the_scan_before_selection(no_library):
    """``large_scores`` on the CPU is the fused score function over the
    first n_valid rows, and selecting from it gives ``topk_large``."""
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(203, 40, 6, 8, 3, 6, seed=9)
    q_sp = sparse_to_torch(JSparse(jnp.asarray(qi), jnp.asarray(qv)))
    c_sp = sparse_to_torch(JSparse(jnp.asarray(ci), jnp.asarray(cv)))
    table = query_table(q_sp, 40)
    args = (table, to_torch(qd), c_sp.indices, c_sp.values, to_torch(cd))
    scores = lk.large_scores(*args, w_dense=0.6, w_sparse=0.4, n_valid=150)
    assert scores.shape == (3, 150)
    got = lk.select_large(scores, 40)
    want = lk.topk_large(*args, 40, w_dense=0.6, w_sparse=0.4, n_valid=150)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_signed_zeros_rank_equal_as_the_plain_version():
    """+0 ranks above -0, as ``lax.top_k`` has them, in the selection's
    emulation and in the plain version (``select_topk``); rows of the same
    zero go to the lower row."""
    from repro_torch.core.brute_force import select_topk

    s = np.array([-0.0, 0.0, -0.0, 0.0, 1.0, np.nan, -1.0], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(s), 7)[1])
    np.testing.assert_array_equal(want, [5, 4, 1, 3, 0, 2, 6])
    for cap in (lk.capacity(7), 1):
        np.testing.assert_array_equal(_select(s, 7, cap)[1], want)
    np.testing.assert_array_equal(select_topk(torch.from_numpy(s)[None], 7)[1].numpy()[0], want)
