"""repro_torch's fused score path (``ops.fused_scores``,
``kernels/sparse_dense.py``, ``ref.fused_score_ref``) held on the CPU
against repro's ``fused_score_pallas`` run as repro's own tests run it
(``ops.fused_scores`` in Pallas interpret mode) and against
``repro.kernels.ref.fused_score_ref``.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the
plain version on the card.  Here the same numpy inputs go through both
packages: the shapes of repro's ``test_fused_kernel_vs_oracle`` (one of
them on its padding path), f32 and bf16, and the weight linearity
``score(wd, ws) = wd * score(1, 0) + ws * score(0, 1)``.  Tolerance: f32
scores within ``F32_RTOL`` (2e-6) of the row's largest |score| (XLA and
PyTorch sum in other orders); bf16 values are upcast before the first
multiply on both sides, so the same bound holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import densify as j_densify
from repro.core.sparse import from_dense as j_from_dense
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.spaces import FusedSpace, FusedVectors
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sparse_dense as sd

from _torch_parity import assert_scores_close, sparse_to_torch, to_torch

pytestmark = pytest.mark.torch

# repro's tests/test_kernels.py test_fused_kernel_vs_oracle: (b, n, v, nnz, dd, tile)
SHAPES = [(6, 384, 100, 8, 32, 128), (2, 200, 64, 16, 16, 64), (8, 512, 200, 4, 64, 256)]


@pytest.fixture
def no_library(monkeypatch):
    """Fail if anything tries to build or load the CUDA library."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = sd.launches
    yield
    assert sd.launches == before


def _data(b, n, v, nnz, dd, seed=0, dtype=jnp.float32):
    """repro (q_sparse, q_dense, c_sparse, c_dense) from numpy, as repro's
    kernel test builds them: COO by ``from_dense`` keeping the ``nnz``
    largest entries (short rows padded with id v)."""
    rng = np.random.default_rng(seed)
    qd = rng.uniform(size=(b, v)) * (rng.uniform(size=(b, v)) > 0.7)
    cd = rng.uniform(size=(n, v)) * (rng.uniform(size=(n, v)) > 0.85)
    qs = j_from_dense(jnp.asarray(qd, jnp.float32), nnz)
    cs = j_from_dense(jnp.asarray(cd, dtype), nnz)
    qv = jnp.asarray(rng.normal(size=(b, dd)), jnp.float32)
    cv = jnp.asarray(rng.normal(size=(n, dd)), dtype)
    return qs, qv, cs, cv


def _port(qs, qv, cs, cv):
    return sparse_to_torch(qs), to_torch(qv), sparse_to_torch(cs), to_torch(cv)


@pytest.mark.parametrize("b,n,v,nnz,dd,tile", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_scores_match_repro(b, n, v, nnz, dd, tile, dtype, no_library):
    qs, qv, cs, cv = _data(b, n, v, nnz, dd, dtype=jnp.dtype(dtype))
    want = jops.fused_scores(qs, qv, cs, cv, v, 0.6, 0.4, tile_n=tile)
    oracle = jref.fused_score_ref(jnp.pad(j_densify(qs, v), ((0, 0), (0, 1))), qv,
                                  cs.indices, cs.values, cv, 0.6, 0.4)
    tq, tqv, tc, tcv = _port(qs, qv, cs, cv)
    assert tc.values.dtype == getattr(torch, dtype) and tcv.dtype == getattr(torch, dtype)
    got = tops.fused_scores(tq, tqv, tc, tcv, v, 0.6, 0.4)
    assert got.shape == (b, n) and got.dtype == torch.float32
    assert_scores_close(np.asarray(want), got.numpy(), ctx=("pallas", dtype))
    assert_scores_close(np.asarray(oracle), got.numpy(), ctx=("ref", dtype))


def test_fused_scores_is_the_fused_space_function(no_library):
    """``ops.fused_scores`` computes ``FusedSpace.score_batch`` for
    dense_kind ip with both components: the same arithmetic, so equal."""
    qs, qv, cs, cv = _data(4, 300, 80, 8, 16, seed=3)
    tq, tqv, tc, tcv = _port(qs, qv, cs, cv)
    space = FusedSpace(80, 0.7, 1.3)
    want = space.score_batch(FusedVectors(tqv, tq), FusedVectors(tcv, tc))
    assert torch.equal(tops.fused_scores(tq, tqv, tc, tcv, 80, 0.7, 1.3), want)


@pytest.mark.parametrize("wd,ws", [(0.0, 0.0), (0.25, 1.75), (2.0, 0.5), (1.3, 0.0)])
def test_weight_linearity(wd, ws, no_library):
    """score(wd, ws) == wd * score(1, 0) + ws * score(0, 1): the
    adjustable-weight property the paper's scenario-1 export relies on
    (repro's test_fused_kernel_weight_linearity).  Both weights always
    apply as rounded products and a rounded sum, so it holds exactly
    here; repro's kernel agrees within the f32 tolerance."""
    b, n, v, nnz, dd = 3, 128, 50, 6, 16
    qs, qv, cs, cv = _data(b, n, v, nnz, dd, seed=7)
    tq, tqv, tc, tcv = _port(qs, qv, cs, cv)
    s_d = tops.fused_scores(tq, tqv, tc, tcv, v, 1.0, 0.0)
    s_s = tops.fused_scores(tq, tqv, tc, tcv, v, 0.0, 1.0)
    s_m = tops.fused_scores(tq, tqv, tc, tcv, v, wd, ws)
    assert torch.equal(s_m, wd * s_d + ws * s_s)
    want = jops.fused_scores(qs, qv, cs, cv, v, wd, ws, tile_n=64)
    assert_scores_close(np.asarray(want), s_m.numpy(), ctx=(wd, ws))


@pytest.mark.parametrize("tile_n", [1, 7, 64, 10_000])
def test_row_blocked_plain_version(tile_n):
    """``fused_score_ref(tile_n=...)`` scores row blocks (bounded gather
    at full scale) and gives the unblocked result up to summation order
    (a one-row block takes another matrix-product path)."""
    qs, qv, cs, cv = _data(5, 203, 60, 8, 12, seed=9)
    tq, tqv, tc, tcv = _port(qs, qv, cs, cv)
    args = (tref.query_table(tq, 60), tqv, tc.indices, tc.values, tcv, 0.6, 0.4)
    assert_scores_close(tref.fused_score_ref(*args).numpy(),
                        tref.fused_score_ref(*args, tile_n=tile_n).numpy(), ctx=tile_n)


def test_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card never reaches the
    plain version: the wrapper raises."""
    m = torch.empty(10, 4, device="meta")
    ids = torch.empty(10, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sd.fused_score(torch.empty(2, 6, device="meta"), torch.empty(2, 4, device="meta"),
                       ids, torch.empty(10, 3, device="meta"), m)


def test_kernel_source_and_entry_point():
    text = (_build.CSRC / "fused_score.cu").read_text()
    assert "fused_score_launch" in text and "fused_score_pallas" in text
    assert sd.QUERIES_PER_BLOCK == 16 and "constexpr int kNarrowQB = 16;" in text
    assert sd.WIDE_QUERIES_PER_BLOCK == 64 and "constexpr int kWideQB = 64;" in text


@pytest.mark.parametrize("b,qb", [(5, 16), (16, 16), (40, 64), (128, 64)])
def test_query_columns_follow_the_thread_layout(b, qb):
    """``query_columns`` puts query ``q0 + qw*qg + 4*h + k`` of each block
    at column ``q0 + h*qb/2 + 4*qg + k``, where thread ``qg`` of the
    kernel reads it (fused_score.cu, the dense loop), and zeros past B."""
    q = torch.arange(b * 3, dtype=torch.float32).reshape(b, 3) + 1.0
    q_t = sd.query_columns(q, qb)
    assert q_t.shape == (3, -(-b // qb) * qb)
    qw = 4 if qb == 16 else 8
    for q0 in range(0, q_t.shape[1], qb):
        for qg in range(qb // qw):
            for h in range(qw // 4):
                for k in range(4):
                    query = q0 + qw * qg + 4 * h + k
                    col = q_t[:, q0 + h * qb // 2 + 4 * qg + k]
                    want = q[query] if query < b else torch.zeros(3)
                    assert torch.equal(col, want), (q0, qg, h, k)
