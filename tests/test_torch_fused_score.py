"""repro_torch's fused score path (``ops.fused_scores``,
``kernels/sparse_dense.py``, ``ref.fused_score_ref``) held on the CPU
against repro's ``fused_score_pallas`` run as repro's own tests run it
(``ops.fused_scores`` in Pallas interpret mode) and against
``repro.kernels.ref.fused_score_ref``.

The CUDA kernels cannot run here; ``chip_smoke.py`` holds them against
the plain version on the card.  Here the same numpy inputs go through both
packages: the shapes of repro's ``test_fused_kernel_vs_oracle`` (one of
them on its padding path), f32 and bf16, and the weight linearity
``score(wd, ws) = wd * score(1, 0) + ws * score(0, 1)``; B4's route
(the fused ring's box or row layout, or ``topk_large.cu``'s row kernel),
decided from the arrays before any launch; and the fused ring's inputs
(the grouped dense queries and the query-term index of every group,
padded groups included, for B4's grid of a block a group and for B2's
clusters), scored through their plain arithmetic, against repro's kernel
at B = 40, 128 and 129 beside ``fused_score`` and
``topk_large.large_scores``.  Tolerance: f32 scores within ``F32_RTOL``
(2e-6) of the row's largest |score| (XLA and PyTorch sum in other
orders); bf16 values are upcast before the first multiply on both sides,
so the same bound holds.
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
from repro_torch.kernels import fused_topk as fk
from repro_torch.kernels import mips_topk as mk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sparse_dense as sd
from repro_torch.kernels import topk_large as lk

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
    before = (sd.launches, sd.ring_launches, sd.row_launches, lk.launches)
    yield
    assert (sd.launches, sd.ring_launches, sd.row_launches, lk.launches) == before


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
    """B4's source is the fused ring's entry point: ``fused_kernel`` with the
    StoreAll epilogue that ``topk_large.cu``'s dense pass runs, a block a
    group (BoxOne or RowTile, no cluster), and no loop of its own."""
    text = (_build.CSRC / "fused_score.cu").read_text()
    assert "fused_score_launch" in text and "fused_score_pallas" in text
    assert '#include "ring.cuh"' in text and "ring::StoreAll" in text and "ring::launch_fused" in text
    assert "ring::BoxOne" in text and "ring::RowTile" in text
    assert "ring::BoxCluster" not in text and "fused_score_clusters" not in text
    assert "__global__" not in text and "score_kernel" not in text and "kWideQB" not in text
    ring = (_build.CSRC / "ring.cuh").read_text()
    assert "struct StoreAll" in ring and "launch_grid" in ring and "copy_cluster" in ring
    assert "using ring::StoreAll;" in (_build.CSRC / "topk_large.cu").read_text()
    for gone in ("query_columns", "block_queries", "WIDE_QUERIES_PER_BLOCK", "QUERIES_PER_BLOCK", "cluster_launches"):
        assert not hasattr(sd, gone), gone


def _ids(n, nnz, offset=0):
    return torch.zeros(n * nnz + offset, dtype=torch.int32)[offset:].view(n, nnz)


def _rows(n, d, dtype=torch.float32, offset=0):
    """[n, d] whose base lies ``offset`` elements past an aligned allocation."""
    return torch.zeros(n * d + offset, dtype=dtype)[offset:].view(n, d)


BF = torch.bfloat16
ROUTES = [
    # (what, c_dense, c_idx, c_val, vocab, route)
    ("MS MARCO f32", _rows(64, 768), _ids(64, 128), _rows(64, 128), 30_522, "box"),
    ("MS MARCO bf16", _rows(64, 768, BF), _ids(64, 128), _rows(64, 128, BF), 30_522, "box"),
    ("d 768, nnz 4", _rows(64, 768), _ids(64, 4), _rows(64, 4), 30_522, "box"),
    ("d 64, nnz 128", _rows(64, 64), _ids(64, 128), _rows(64, 128), 1000, "box"),
    ("d 64, nnz 1", _rows(64, 64), _ids(64, 1), _rows(64, 1), 1000, "row_kernel"),
    ("DIN d 18, nnz 1", _rows(64, 18), _ids(64, 1), _rows(64, 1), 50, "rows"),
    ("DIN bf16 d 18, nnz 4", _rows(64, 18, BF), _ids(64, 4), _rows(64, 4, BF), 50, "rows"),
    ("d 18, nnz 128", _rows(64, 18), _ids(64, 128), _rows(64, 128), 1000, "row_kernel"),
    ("d 18, nnz 32, V 250,000", _rows(64, 18), _ids(64, 32), _rows(64, 32), 250_000, "row_kernel"),
    ("d 61, nnz 128", _rows(64, 61), _ids(64, 128), _rows(64, 128), 1000, "row_kernel"),
    ("d 61, nnz 1", _rows(64, 61), _ids(64, 1), _rows(64, 1), 1000, "row_kernel"),
    ("bf16 d 768, nnz 4", _rows(64, 768, BF), _ids(64, 4), _rows(64, 4, BF), 1000, "row_kernel"),
    ("two dtypes", _rows(64, 768), _ids(64, 128), _rows(64, 128, BF), 1000, "row_kernel"),
    ("DIN, two dtypes", _rows(64, 18, BF), _ids(64, 1), _rows(64, 1), 50, "row_kernel"),
    ("dense 4 bytes off", _rows(64, 768, offset=1), _ids(64, 128), _rows(64, 128), 1000, "row_kernel"),
    ("a shard at an odd row of d 18", _rows(64, 18, offset=18), _ids(64, 1, offset=1), _rows(64, 1, offset=1), 50,
     "row_kernel"),
]


@pytest.mark.parametrize("what,c_dense,c_idx,c_val,vocab,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_route(what, c_dense, c_idx, c_val, vocab, want, no_library):
    """B4's route is decided from the arrays' shapes, dtypes and alignment on the CPU, before any launch: the
    fused ring's box layout, its row layout, or topk_large.cu's row kernel for what neither takes."""
    assert sd.route(c_dense, c_idx, c_val, vocab) == want, what
    if want != "row_kernel":   # the case is what it claims: aligned, one dtype
        assert all(t.data_ptr() % 16 == 0 for t in (c_dense, c_idx, c_val)) and c_dense.dtype == c_val.dtype


def _ring_scores(table, q, c_idx, c_val, c_dense, vocab, wd, ws, grid):
    """The fused score through the fused ring's own inputs for ``grid`` (``fused_topk.ring_queries``): the
    dense queries read back from their groups, the sparse part through every group's query-term index
    (``ref.index_sparse_scores``), the mix; the padded groups' queries must score exactly 0."""
    qg, words, tbl = fk.ring_queries(q, table, grid)
    b, d = q.shape
    rows = grid.padded * fk.GROUP
    queries = qg.transpose(1, 2).reshape(rows, -1)[:, :d]
    dense = queries @ c_dense.float().T
    sparse = tref.index_sparse_scores(words, tbl, c_idx, c_val, vocab, rows)
    mixed = wd * dense + ws * sparse
    assert not bool(mixed[b:].any()), "a padded query scored"
    return mixed[:b]


@pytest.mark.parametrize("cluster", [False, True], ids=["b4 grid", "b2 clusters"])
@pytest.mark.parametrize("b", [40, 128, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ring_inputs_match_repro(b, dtype, cluster, no_library):
    """At B = 40 (a partial group), 128 and 129 (a padded group; as B2's clusters, a cluster of 8 and two rows
    of clusters with padded groups), the fused ring's inputs for B4's grid (a block a group) and for B2's
    clusters score as repro's ``fused_score_pallas`` (interpret mode), and so do ``sparse_dense.fused_score``
    and ``topk_large.large_scores`` on the CPU."""
    n, v, nnz, dd = 512, 200, 16, 32
    qs, qv, cs, cv = _data(b, n, v, nnz, dd, seed=b, dtype=jnp.dtype(dtype))
    want = np.asarray(jops.fused_scores(qs, qv, cs, cv, v, 0.6, 0.4, tile_n=128))
    tq, tqv, tc, tcv = _port(qs, qv, cs, cv)
    table = tref.query_table(tq, v)
    assert sd.route(tcv, tc.indices, tc.values, v) == "box"
    grid = fk.fused_grid(b, "box", 132, cluster=cluster)
    assert grid.padded * fk.GROUP >= b and (grid.width > 1) == cluster
    assert grid == mk.ring_grid(b, fk.ring_blocks("box", 132), cluster)
    got = _ring_scores(table, tqv, tc.indices, tc.values, tcv, v, 0.6, 0.4, grid)
    assert_scores_close(want, got.numpy(), ctx=("ring inputs", b, dtype))
    assert_scores_close(want, sd.fused_score(table, tqv, tc.indices, tc.values, tcv, 0.6, 0.4).numpy(),
                        ctx=("fused_score", b, dtype))
    large = lk.large_scores(table, tqv, tc.indices, tc.values, tcv, 0.6, 0.4)
    assert_scores_close(want, large.numpy(), ctx=("large_scores", b, dtype))
