"""repro_torch's large-k top-k (``kernels/topk_large.py``, the kernels
for k above the scan kernels' ``MAX_K``) on the CPU, its plain version,
held against ``repro.kernels.ref`` on small corpora up to k = n_valid;
and a numpy form of the select kernel's radix select held against
``lax.top_k``.

The CUDA kernels cannot run here; ``chip_smoke.py`` (phase "small") holds
them against this plain version on the card.  Tolerances: ids equal; f32
scores within ``F32_RTOL`` (2e-6) of the row's largest |score|.
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


@pytest.mark.parametrize("space", ["ip", "l2"])
def test_topk_large_dense_kinds_match_repro(space, no_library):
    q, c, planted = planted_margin_corpus(300, 16, 3, 8, seed=5)
    got = tops.topk_large(None, to_torch(q), None, to_torch(c), 0, 290, dense_kind=space,
                          n_valid=290)
    assert_topk_match(jref.mips_topk_ref(q, c, 290, n_valid=290, space=space), got, ctx=space)
    if space == "ip":
        assert set(np.asarray(got.indices)[:, :8].ravel()) == set(np.asarray(planted).tolist())


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
    """``order_key`` of ``csrc/topk_large.cu``: uint32 keys in score order,
    NaN above +inf, -0 equal to +0."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    u = x.view(np.uint32)
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), key)


def _select(s, k):
    """The select kernel for one query in numpy: a radix select of the
    k-th key, 8 bits a pass; the rows above it, then the lowest-numbered
    rows at it; sorted NaN first, score descending, row ascending."""
    key = _order_key(s)
    prefix, mask, need = 0, 0, k
    for shift in (24, 16, 8, 0):
        hist = np.bincount((key[(key & mask) == prefix] >> shift) & 255, minlength=256)
        b = 255
        while b > 0 and hist[b] < need:
            need -= hist[b]
            b -= 1
        prefix |= b << shift
        mask |= 255 << shift
    rows = np.concatenate([np.flatnonzero(key > prefix), np.flatnonzero(key == prefix)[:need]])
    assert rows.size == k
    sv = s[rows]
    order = np.lexsort((rows, -np.where(np.isnan(sv), 0.0, sv.astype(np.float64)), ~np.isnan(sv)))
    return sv[order], rows[order]


@pytest.mark.parametrize("case", ["normal", "ties", "extremes", "nan"])
def test_select_emulation_matches_lax_top_k(case):
    """The radix select and its tie fill give ``lax.top_k``'s top k: ties
    on the k-th score (quantised scores), +-inf and f32-min, NaN above
    +inf, at k from 1 to N.  Signed zeros are left out: ``lax.top_k``
    puts +0 above -0, the port's exact paths (the scan kernels, their
    plain versions and this kernel) rank them equal (ROADMAP queue C)."""
    rng = np.random.default_rng(["normal", "ties", "extremes", "nan"].index(case))
    n = 3000
    s = rng.standard_normal(n).astype(np.float32)
    if case == "ties":
        s = np.round(s * 4).astype(np.float32) + np.float32(0.5)
    if case in ("extremes", "nan"):
        x = rng.uniform(size=n)
        s[x < 0.1] = np.inf
        s[(x >= 0.1) & (x < 0.2)] = -np.inf
        s[(x >= 0.2) & (x < 0.3)] = np.finfo(np.float32).min
        s[(x >= 0.3) & (x < 0.4)] = np.finfo(np.float32).max
    if case == "nan":
        s[rng.uniform(size=n) < 0.1] = np.nan
    for k in (1, 7, 2049, 2100, n // 2, n):
        want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
        got_s, got_i = _select(s, k)
        np.testing.assert_array_equal(np.asarray(want_i), got_i, err_msg=f"{case} k={k}")
        np.testing.assert_array_equal(np.asarray(want_s), got_s)


def test_signed_zeros_rank_equal_as_the_plain_version():
    """+0 and -0 tie and go to the lower row, as the plain version's
    stable sort (``select_topk``) has them."""
    from repro_torch.core.brute_force import select_topk

    s = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0], np.float32)
    got_s, got_i = _select(s, 4)
    np.testing.assert_array_equal(got_i, [2, 0, 1, 3])
    np.testing.assert_array_equal(select_topk(torch.from_numpy(s)[None], 4)[1].numpy()[0], got_i)
