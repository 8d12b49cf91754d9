"""repro_torch kernel wrappers on the CPU (their plain versions) held
against repro's kernels run as repro's own tests run them (Pallas
interpret mode, the default) and against ``repro.kernels.ref``.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds them
against these plain versions on the card.  Here: the same numpy inputs
through both packages on margin-planted data.  Tolerances: ids equal;
f32 scores within ``F32_RTOL`` (2e-6) of the row's largest |score|; a bf16
corpus is held to the same bound against repro's bf16 path (both upcast
the same stored values) and to recall@k == 1.0 plus ``BF16_MAX_ULP``
against the f32 oracle (``tests/_precision.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.core.brute_force import TopK as JTopK
from repro.core.sparse import SparseVectors as JSparse
from repro_torch.core.brute_force import TopK
from repro_torch.kernels import _build
from repro_torch.kernels import fused_topk as fk
from repro_torch.kernels import mips_topk as mk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _precision import assert_bf16_oracle_contract, planted_margin_corpus
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
    before = (mk.launches, fk.launches)
    yield
    assert (mk.launches, fk.launches) == before


# (n, d, b, k, n_valid): ragged n, n_valid < n, k = 1, k = planted count
DENSE_CASES = [(203, 16, 3, 5, None), (257, 8, 4, 1, 250), (300, 12, 2, 12, 290)]


@pytest.mark.parametrize("space", ["ip", "l2"])
@pytest.mark.parametrize("case", DENSE_CASES)
def test_mips_topk_matches_repro(space, case, no_library):
    n, d, b, k, n_valid = case
    q, c, planted = planted_margin_corpus(n, d, b, k, seed=n)
    want = jops.mips_topk(q, c, k, tile_n=64, space=space, n_valid=n_valid)
    got = tops.mips_topk(to_torch(q), to_torch(c), k, space=space, n_valid=n_valid)
    assert isinstance(got, TopK) and got.indices.dtype == torch.int32
    assert_topk_match(want, got, ctx=case)
    assert set(np.asarray(got.indices).ravel()) == set(np.asarray(planted).tolist())
    oracle = jref.mips_topk_ref(q, c, k, n_valid=n_valid, space=space)
    assert_topk_match(oracle, tref.mips_topk_ref(to_torch(q), to_torch(c), k,
                                                 n_valid=n_valid, space=space))
    # the tiled plain version selects the same rows
    assert_topk_match(oracle, tref.mips_topk_ref(to_torch(q), to_torch(c), k, n_valid=n_valid,
                                                 space=space, tile_n=37))


@pytest.mark.parametrize("space", ["ip", "l2"])
def test_mips_topk_bf16(space, no_library):
    q, c, _ = planted_margin_corpus(300, 16, 3, 8, seed=1)
    cb = c.astype(jnp.bfloat16)
    want = jops.mips_topk(q, cb, 8, tile_n=128, space=space)
    got = tops.mips_topk(to_torch(q), to_torch(cb), 8, space=space)
    assert_topk_match(want, got)
    oracle = jref.mips_topk_ref(q, c, 8, space=space)
    assert_bf16_oracle_contract(JTopK(*oracle), got)


def _fused_inputs(variant, dtype, n=203, v=40, nnz=6, dd=8, b=3, k=6, dups=()):
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(n, v, nnz, dd, b, k, seed=n, dups=dups)
    c_dense = jnp.asarray(cd, dtype) if variant != "sparse" else None
    q_dense = jnp.asarray(qd, jnp.float32) if variant != "sparse" else None
    c_sp = JSparse(jnp.asarray(ci), jnp.asarray(cv, dtype)) if variant != "dense" else None
    q_sp = JSparse(jnp.asarray(qi), jnp.asarray(qv, jnp.float32)) if variant != "dense" else None
    weights = {"fused": (0.6, 0.4), "dense": (0.7, None), "sparse": (None, None)}[variant]
    return (q_sp, q_dense, c_sp, c_dense, v, k), weights


@pytest.mark.parametrize("variant", ["fused", "dense", "sparse"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_topk_matches_repro(variant, dtype, no_library):
    args, (wd, ws) = _fused_inputs(variant, dtype)
    q_sp, q_dense, c_sp, c_dense, v, k = args
    want = jops.fused_topk(*args, w_dense=wd, w_sparse=ws, tile_n=64, n_valid=200)
    got = tops.fused_topk(sparse_to_torch(q_sp), to_torch(q_dense), sparse_to_torch(c_sp),
                          to_torch(c_dense), v, k, w_dense=wd, w_sparse=ws, n_valid=200)
    assert_topk_match(want, got, ctx=(variant, dtype))
    oracle = jref.fused_topk_ref(*args, w_dense=wd, w_sparse=ws, n_valid=200)
    assert_topk_match(oracle, tref.fused_topk_ref(
        sparse_to_torch(q_sp), to_torch(q_dense), sparse_to_torch(c_sp), to_torch(c_dense),
        v, k, w_dense=wd, w_sparse=ws, n_valid=200, tile_n=50))


def test_ties_break_toward_lower_id(no_library):
    # rows 1 and 2 copy row 0, a planted top row: three equal scores
    args, (wd, ws) = _fused_inputs("fused", jnp.float32, n=96, k=4, dups=(1, 2))
    q_sp, q_dense, c_sp, c_dense, v, k = args
    want = jops.fused_topk(*args, w_dense=wd, w_sparse=ws, tile_n=32)
    got = tops.fused_topk(sparse_to_torch(q_sp), to_torch(q_dense), sparse_to_torch(c_sp),
                          to_torch(c_dense), v, k, w_dense=wd, w_sparse=ws)
    assert_topk_match(want, got)
    assert (got.indices[:, :3] == torch.tensor([0, 1, 2], dtype=torch.int32)).all()


def test_weight_rules():
    t = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="requires w_dense and w_sparse"):
        tref.fused_table_scores(t, t, torch.zeros(3, 2, dtype=torch.int32),
                                torch.zeros(3, 2), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="no overlapping components"):
        tops.fused_topk(None, None, None, None, 4, 1)
    assert fk._weights(0.5, None, True, False) == (True, 0.5, 0.0)
    assert fk._weights(None, None, False, True) == (False, 0.0, 0.0)
    with pytest.raises(ValueError):
        fk._weights(0.5, None, True, True)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never reaches a
    plain version: the wrappers raise."""
    c = torch.empty(10, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        mk.mips_topk(torch.empty(2, 4, device="meta"), c, 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fk.fused_topk(None, torch.empty(2, 4, device="meta"), None, None, c, 3, w_dense=1.0)


@pytest.mark.parametrize("b,n,k", [(16, 8_841_823, 100), (16, 8_841_823, 2000),
                                   (5, 3001, 1), (1, 300, 256), (16, 2048, 2048)])
def test_launch_plan(b, n, k):
    qb, buf, n_splits, rows = mk.plan(b, n, k, n_sms=132)
    assert buf & (buf - 1) == 0 and buf >= k + mk.TILE
    assert qb in (4, 16) and qb * buf * 8 <= 128 * 1024    # candidate lists in shared memory
    assert rows % mk.TILE == 0 and n_splits * rows >= n > (n_splits - 1) * rows
    with pytest.raises(ValueError):
        mk.check_k(mk.MAX_K + 1, 10**6)
    with pytest.raises(ValueError):
        mk.check_k(11, 10)


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    src = _build.CSRC / "topk_scan.cu"
    text = src.read_text()
    assert "mips_topk_launch" in text and "fused_topk_launch" in text
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
