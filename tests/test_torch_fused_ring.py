"""B2's ring route (``csrc/fused_topk.cu``: B1's sample, filter and merge
on the fused ring of ``csrc/ring.cuh``) through its plain emulation
(``ref.fused_filter_ref``, the plan the wrapper gives each layout), held
against repro's B2, ``fused_topk_pallas`` run in interpret mode as repro's
own tests run it, and against repro's reference backend; and the routing
of ``fused_topk`` among the box layout, the row layout and the scan route.

The emulation repeats the route step for step over the fused scores: a
sample of every ``stride``-th tile and its top k, its k-th (score, row) as
each filter block's first threshold, each block's tiles in its order with
its lists sorted down to their best k when they could overflow, and the
merge of the sample's top k, the lists and the rows past ``n_valid``.

Inputs are small integers drawn with numpy from a seed: dense parts
nonzero in [-3, 3], COO values in [1, 3], query values in [1, 4], the
weights 0.5 and 0.25, so that every score is exact in f32 (and every
input exact in bf16) and no sum is -0 (a miss's product is +0): ids equal
and scores equal bit for bit, 0 ULPs.  N = 3,001 rows leaves a ragged last
tile.  Cases: fused (ip and l2) and sparse-only; f32 and bf16 (crossing
as uint16 bits); D = 18 with nnz = 1 and 5 (the row layout) and D = 32
with nnz = 128 (the box layout); n_valid below N; k = 1, 10 and 356;
plan overrides that run a sample and a filter on so small a corpus, and
a corpus whose sampled tiles score lowest, so that the lists overflow and
are sorted; ids past V and negative ones (repro's indexing: a negative id
counts from the end once, then ids clamp to [0, V]), a repeated query
term and an all-pad query.  Margin-planted random corpora (float data)
are held to the contract: ids equal, f32 scores within ``F32_RTOL`` of
the row scale, a bf16 corpus to recall 1.0 and ``BF16_MAX_ULP`` against
the f32 oracle.  The ring's grid above 16 queries (thread-block clusters
of up to 8 groups, two rows of clusters past 128; B2's by default up to
``CLUSTER_QUERIES`` queries) and the inputs its blocks read, padded
groups zero, are held at B = 1 to 200.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core.sparse import SparseVectors as JSparse
from repro.core.spaces import FusedSpace as JFused
from repro.core.spaces import FusedVectors as JFusedVectors
from repro.core.spaces import SparseSpace as JSparseSpace
from repro.core.brute_force import TopK as JTopK
from repro.kernels import ops as jops
from repro_torch.core.brute_force import TopK
from repro_torch.kernels import _build
from repro_torch.kernels import fused_topk as fk
from repro_torch.kernels import mips_topk as mk
from repro_torch.kernels import ref as tref
from repro_torch.kernels.query_index import table_from_index

from _precision import assert_bf16_oracle_contract
from _torch_parity import assert_topk_match, np_of, planted_fused_np, sparse_to_torch, to_torch

pytestmark = pytest.mark.torch

N, B, V, NNZ_Q = 3001, 3, 40, 6
W = (0.5, 0.25)
# (layout, d, nnz): D = 18 whole rows with one and five slots, a box of 32 columns and 128 slots
SHAPES = [("rows", 18, 1), ("rows", 18, 5), ("box", 32, 128)]
PARTS = ["fused ip", "fused l2", "sparse"]
# (k, n_valid, plan overrides): a small corpus is all sample by default; the overrides run a filter
KS = [(1, None, {}), (10, 2600, dict(stride=3, blocks=5)), (356, 2989, dict(stride=2, blocks=3))]


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    counts = lambda: (fk.launches, fk.ring_launches, fk.row_launches, fk.cluster_launches, fk.scan_launches,
                      mk.launches)
    before = counts()
    yield
    assert counts() == before


def _bits(x):
    return np.asarray(np_of(x), np.float32).view(np.int32)


def _nonzero(rng, shape, m):
    """Integers in [-m, m] but 0."""
    return (rng.integers(1, m + 1, shape) * rng.choice([-1, 1], shape)).astype(np.float32)


def _draw(seed, d, nnz, n=N, b=B):
    """Integer inputs: corpus (dense, ids, values), queries (dense, ids, values)."""
    rng = np.random.default_rng(seed)
    cd = _nonzero(rng, (n, d), 3)
    ci = rng.integers(0, V, (n, nnz)).astype(np.int32)
    cv = rng.integers(1, 4, (n, nnz)).astype(np.float32)
    qd = _nonzero(rng, (b, d), 3)
    qi = rng.integers(0, V, (b, NNZ_Q)).astype(np.int32)
    qv = rng.integers(1, 5, (b, NNZ_Q)).astype(np.float32)
    return (cd, ci, cv), (qd, qi, qv)


class Case:
    """One input through both packages: repro's COO queries and corpus, and the port's kernel arguments."""

    def __init__(self, corpus, queries, part, dtype):
        (cd, ci, cv), (qd, qi, qv) = corpus, queries
        self.part, self.kind = part.split()[0], (part.split() + ["ip"])[1]
        jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        self.j_c = JSparse(jnp.asarray(ci), jnp.asarray(cv, jt))
        self.j_q = JSparse(jnp.asarray(qi), jnp.asarray(qv))
        self.j_cd, self.j_qd = jnp.asarray(cd, jt), jnp.asarray(qd)
        self.table = tref.query_table(sparse_to_torch(self.j_q), V)
        self.c_idx, self.c_val = to_torch(self.j_c.indices), to_torch(self.j_c.values)
        fused = self.part == "fused"
        self.c_dense = to_torch(self.j_cd) if fused else None
        self.q_dense = to_torch(self.j_qd) if fused else None
        self.w = dict(w_dense=W[0], w_sparse=W[1]) if fused else dict(w_dense=None, w_sparse=None)

    def args(self):
        return (self.table, self.q_dense, self.c_idx, self.c_val, self.c_dense)

    def layout(self):
        return fk.ring_layout(self.c_dense, self.c_idx, self.c_val, V)

    def emulate(self, k, n_valid, over):
        """The ring's emulation under the wrapper's plan, and the CPU wrapper on it."""
        n = self.c_idx.shape[0]
        nv = n if n_valid is None else n_valid
        plan = mk.filter_plan(n, nv, k, fk.ring_blocks(self.layout(), 132), **over)
        got = tref.fused_filter_ref(*self.args(), k, plan, dense_kind=self.kind, n_valid=n_valid, **self.w)
        wrap = fk.fused_filter(*self.args(), k, n_valid=n_valid, dense_kind=self.kind, **over, **self.w)
        assert torch.equal(wrap[1], got[1]) and torch.equal(wrap[0].view(torch.int32), got[0].view(torch.int32))
        assert torch.equal(wrap[2], got[2])
        return (*got, plan)

    def pallas(self, k, n_valid):
        """repro's B2 in interpret mode."""
        if self.part == "fused":
            return jops.fused_topk(self.j_q, self.j_qd, self.j_c, self.j_cd, V, k, w_dense=W[0], w_sparse=W[1],
                                   dense_kind=self.kind, tile_n=512, n_valid=n_valid)
        return jops.fused_topk(self.j_q, None, self.j_c, None, V, k, tile_n=512, n_valid=n_valid)

    def reference(self, k, n_valid):
        """repro's reference backend."""
        if self.part == "fused":
            return jb.ReferenceBackend().topk(JFused(V, W[0], W[1], self.kind), JFusedVectors(self.j_qd, self.j_q),
                                              JFusedVectors(self.j_cd, self.j_c), k, n_valid=n_valid)
        return jb.ReferenceBackend().topk(JSparseSpace(V), self.j_q, self.j_c, k, n_valid=n_valid)


def _equal(want_s, want_i, got_s, got_i, ctx):
    np.testing.assert_array_equal(np.asarray(want_i), np_of(got_i), err_msg=ctx)
    np.testing.assert_array_equal(_bits(want_s), _bits(got_s), err_msg=ctx)


def _hold(case, k, n_valid, over, ctx, pallas=True):
    got_s, got_i, stats, plan = case.emulate(k, n_valid, over)
    if pallas and k <= 10:   # repro's Pallas B2 in interpret mode (its max / argmax rounds grow with k)
        want = case.pallas(k, n_valid)
        _equal(want.scores, want.indices, got_s, got_i, ctx)
    ref = case.reference(k, n_valid)
    _equal(ref.scores, ref.indices, got_s, got_i, ctx)
    plain_s, plain_i = tref.fused_topk_table_ref(*case.args(), k, dense_kind=case.kind, n_valid=n_valid, **case.w)
    assert torch.equal(plain_i, got_i) and torch.equal(plain_s.view(torch.int32), got_s.view(torch.int32))
    assert bool((stats[:, 1] >= plan.k_sample + plan.masked).all())   # the sample's list and the masked rows
    return stats, plan


@pytest.mark.parametrize("k,n_valid,over", KS, ids=[f"k{k}" for k, _, _ in KS])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("layout,d,nnz", SHAPES, ids=[f"{x}-d{d}-nnz{z}" for x, d, z in SHAPES])
def test_emulation_matches_repro(layout, d, nnz, part, dtype, k, n_valid, over, no_library):
    case = Case(*_draw(100 * nnz + d + k, d, nnz), part, dtype)
    assert case.layout() == layout, (case.layout(), layout)
    stats, plan = _hold(case, k, n_valid, over, f"{layout} d{d} nnz{nnz} {part} {dtype} k{k}")
    if over:
        assert plan.stride > 1 and plan.blocks > 0, plan   # a sample and a filter
    assert int(stats[:, 0].sum()) == 0, stats


def _blind(seed, d, nnz):
    """Rows of the sampled tiles (every 8th) score lowest: their dense part is 1 against queries of 1
    where every other row's is 2, and their COO slots hold id 0, which no query holds, where every other
    row's hold id 1, which every query holds: every row of the filter passes, the lists overflow and are
    sorted."""
    (cd, ci, cv), (qd, qi, qv) = _draw(seed, d, nnz)
    qd[:] = 1.0
    qi[qi == 0] = 1
    qi[:, 0] = 1
    cd[:] = 2.0
    ci[:] = 1
    sampled = (np.arange(N) // mk.TILE) % 8 == 0
    cd[sampled] = 1.0
    ci[sampled] = 0
    return (cd, ci, cv), (qd, qi, qv)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("part", ["fused ip", "sparse"])
@pytest.mark.parametrize("layout,d,nnz", SHAPES, ids=[f"{x}-d{d}-nnz{z}" for x, d, z in SHAPES])
def test_lists_overflow(layout, d, nnz, part, dtype, no_library):
    case = Case(*_blind(7 + nnz, d, nnz), part, dtype)
    stats, _ = _hold(case, 64, None, dict(stride=8, blocks=2), f"blind {layout} nnz{nnz} {part} {dtype}",
                     pallas=False)
    assert bool((stats[:, 0] > 0).all()), stats


def _stress(seed, d, nnz):
    """Ids past V and negative ones in the corpus (-(V + 1) .. -1 count from the end, below that they
    clamp to 0), a query that repeats one term (its values add up), an all-pad query (id V, value 0)."""
    (cd, ci, cv), (qd, qi, qv) = _draw(seed, d, nnz, b=4)
    rng = np.random.default_rng(seed + 1)
    bad = rng.uniform(size=ci.shape) < 0.2
    ci[bad] = rng.choice([V, V + 1, V + 7, 10**6, -1, -5, -(V + 1), -(V + 2), -10**6], size=int(bad.sum()))
    qi[1, :] = qi[1, 0]
    qi[2, :] = V
    qv[2, :] = 0.0
    qi[3, :3] = [0, V - 1, V]   # the first and the last term and the pad id
    return (cd, ci, cv), (qd, qi, qv)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("layout,d,nnz", SHAPES, ids=[f"{x}-d{d}-nnz{z}" for x, d, z in SHAPES])
def test_index_stress(layout, d, nnz, part, dtype, no_library):
    case = Case(*_stress(31 + nnz, d, nnz), part, dtype)
    _hold(case, 10, 2990, dict(stride=3, blocks=4), f"stress {layout} nnz{nnz} {part} {dtype}", pallas=False)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant,k,over", [("fused", 8, {}), ("fused", 8, dict(stride=2, blocks=3)),
                                            ("sparse", 8, dict(stride=3, blocks=2))])
def test_planted_margin(variant, k, over, dtype, no_library):
    """Float data with a planted top k (benchmarks/common.py planted_margin_fused): ids equal, scores
    within F32_RTOL of the row scale; bf16 recall 1.0 and BF16_MAX_ULP against the f32 oracle."""
    (cd, ci, cv), (qd, qi, qv) = planted_fused_np(2048, 200, 8, 32, 4, k, seed=k + len(over))
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    j_c, j_q = JSparse(jnp.asarray(ci), jnp.asarray(cv, jt)), JSparse(jnp.asarray(qi), jnp.asarray(qv))
    fused = variant == "fused"
    j_cd, j_qd = (jnp.asarray(cd, jt), jnp.asarray(qd)) if fused else (None, None)
    w = dict(w_dense=0.6, w_sparse=0.4) if fused else {}
    table = tref.query_table(sparse_to_torch(j_q), 200)
    got = fk.fused_filter(table, to_torch(j_qd), to_torch(j_c.indices), to_torch(j_c.values), to_torch(j_cd), k,
                          **over, **w)
    want = jops.fused_topk(j_q, j_qd, j_c, j_cd, 200, k, tile_n=512, **w)
    assert_topk_match(want, got[:2], ctx=(variant, dtype, over))
    if dtype == "bf16":
        j_c32 = JSparse(jnp.asarray(ci), jnp.asarray(cv))
        oracle = jops.fused_topk(j_q, j_qd, j_c32, None if j_cd is None else jnp.asarray(cd), 200, k, tile_n=512,
                                 **w)
        assert_bf16_oracle_contract(JTopK(*oracle), TopK(*got[:2]))


def _ids(n, nnz, offset=0, dtype=torch.int32):
    return torch.zeros(n * nnz + offset, dtype=dtype)[offset:].view(n, nnz)


def _rows(n, d, dtype=torch.float32, offset=0):
    """[n, d] whose base lies ``offset`` elements past an aligned allocation."""
    return torch.zeros(n * d + offset, dtype=dtype)[offset:].view(n, d)


ROUTES = [
    # (what, c_dense, c_idx, c_val, vocab, route)
    ("MS MARCO f32", _rows(64, 768), _ids(64, 128), _rows(64, 128), 30_522, "box"),
    ("MS MARCO bf16", _rows(64, 768, torch.bfloat16), _ids(64, 128), _rows(64, 128, torch.bfloat16), 30_522, "box"),
    ("sparse-only nnz 128", None, _ids(64, 128), _rows(64, 128), 30_522, "box"),
    ("sparse-only V 250,000", None, _ids(64, 128), _rows(64, 128), 250_000, "box"),
    ("dense-only d 64", _rows(64, 64), None, None, 0, "box"),
    ("DIN items, one tag", _rows(64, 18), _ids(64, 1), _rows(64, 1), 50, "rows"),
    ("DIN items bf16, one tag", _rows(64, 18, torch.bfloat16), _ids(64, 1), _rows(64, 1, torch.bfloat16), 50,
     "rows"),
    ("d 18, nnz 5", _rows(64, 18), _ids(64, 5), _rows(64, 5), 1000, "rows"),
    ("sparse-only nnz 5", None, _ids(64, 5), _rows(64, 5), 30_522, "rows"),
    ("bf16 values, nnz 4", None, _ids(64, 4), _rows(64, 4, torch.bfloat16), 1000, "rows"),
    ("dense-only d 18", _rows(64, 18), None, None, 0, "rows"),
    ("d 16 box, nnz 1 rows", _rows(64, 16), _ids(64, 1), _rows(64, 1), 1000, "rows"),
    ("d 61", _rows(64, 61), _ids(64, 16), _rows(64, 16), 1000, None),
    ("odd d 17", _rows(64, 17), _ids(64, 1), _rows(64, 1), 1000, None),
    ("d 64 box, nnz 5", _rows(64, 64), _ids(64, 5), _rows(64, 5), 1000, None),
    ("d 18, nnz 128", _rows(64, 18), _ids(64, 128), _rows(64, 128), 1000, None),
    ("nnz 33", None, _ids(64, 33), _rows(64, 33), 1000, None),
    ("two dtypes", _rows(64, 768), _ids(64, 128), _rows(64, 128, torch.bfloat16), 1000, None),
    ("dense 4 bytes off", _rows(64, 768, offset=1), _ids(64, 128), _rows(64, 128), 1000, None),
    ("ids 4 bytes off", _rows(64, 768), _ids(64, 128, offset=1), _rows(64, 128), 1000, None),
    ("a shard at an odd row of d 18", _rows(64, 18, offset=18), _ids(64, 1, offset=1), _rows(64, 1, offset=1), 50,
     None),
    ("d 18, nnz 32, V 250,000", _rows(64, 18), _ids(64, 32), _rows(64, 32), 250_000, None),
]


@pytest.mark.parametrize("what,c_dense,c_idx,c_val,vocab,route", ROUTES, ids=[r[0] for r in ROUTES])
def test_routing(what, c_dense, c_idx, c_val, vocab, route, no_library):
    assert fk.ring_layout(c_dense, c_idx, c_val, vocab) == route, what
    for t in (c_dense, c_idx, c_val):   # the case is what it claims: aligned unless it says otherwise
        if t is not None and route is not None:
            assert t.data_ptr() % 16 == 0


def test_wrappers_on_the_cpu(no_library):
    """On CPU tensors ``fused_topk`` runs the plain version, ``fused_scan`` the same, ``fused_filter`` the
    emulation, whatever the route the arrays would take on the card."""
    (cd, ci, cv), (qd, qi, qv) = _draw(5, 61, 3)
    case = Case((cd, ci, cv), (qd, qi, qv), "fused l2", "f32")
    assert case.layout() is None
    plain = tref.fused_topk_table_ref(*case.args(), 20, dense_kind="l2", n_valid=2000, **case.w)
    for fn in (fk.fused_topk, fk.fused_scan):
        s, i = fn(*case.args(), 20, dense_kind="l2", n_valid=2000, **case.w)
        assert torch.equal(i, plain[1]) and torch.equal(s.view(torch.int32), plain[0].view(torch.int32))
    s, i, _ = fk.fused_filter(*case.args(), 20, dense_kind="l2", n_valid=2000, **case.w)
    assert torch.equal(i, plain[1]) and torch.equal(s.view(torch.int32), plain[0].view(torch.int32))
    with pytest.raises(ValueError, match="no components"):
        fk.fused_topk(None, None, None, None, None, 3)


def test_kernel_source_shares_b1s_selection(no_library):
    """B2's ring route runs filter.cuh's epilogues and merge, the code B1 runs, on ring.cuh's fused kernel."""
    src = (_build.CSRC / "fused_topk.cu").read_text()
    assert '#include "filter.cuh"' in src and "fused_filter_launch" in src
    assert "b1::run_passes" in src and "SampleTiles" in src and "FilterTiles" in src
    assert '#include "filter.cuh"' in (_build.CSRC / "mips_topk.cu").read_text()
    ring = (_build.CSRC / "ring.cuh").read_text()
    assert "fused_kernel" in ring and "sparse_box" in ring and "rows_round" in ring and "topk::index_row" in ring


# (b, clusters' width, rows of clusters): G = ceil(b / 16) groups; one group a block up to 16 queries, then
# clusters of up to 8 groups, two rows of clusters past 128 queries
GRIDS = [(1, 1, 1), (16, 1, 1), (17, 2, 1), (64, 4, 1), (128, 8, 1), (129, 5, 2), (200, 7, 2)]


@pytest.mark.parametrize("b,width,rows", GRIDS, ids=[f"b{b}" for b, _, _ in GRIDS])
def test_ring_grid_and_queries(b, width, rows, no_library):
    """The fused ring's grid for b queries on the box layout (132 SMs, two blocks an SM: the clusters along x
    are ``persistent // width`` here, ``cudaOccupancyMaxActiveClusters`` on the card), and the inputs its
    blocks read (``fused_topk.ring_queries``): block y's 16 dense queries as [D rounded up to 32, 16] and its
    query-term index, for rows x width groups, those past the batch zero; a block a group lays the same
    groups out."""
    groups = -(-b // 16)
    persistent = fk.ring_blocks("box", 132)
    grid = mk.ring_grid(b, persistent)
    assert (grid.groups, grid.width, grid.rows) == (groups, width, rows)
    # B2 asks for these clusters up to CLUSTER_QUERIES queries by default, at any B when told to
    assert fk.fused_grid(b, "box", 132, cluster=True) == grid
    assert fk.fused_grid(b, "box", 132) == (grid if b <= fk.CLUSTER_QUERIES else mk.ring_grid(b, persistent, False))
    assert fk.fused_grid(b, "rows", 132, cluster=True) == mk.RingGrid(groups, 1, groups, 264)
    assert grid.blocks == persistent // width and grid.padded == width * rows
    assert groups <= grid.padded and (grid.padded - width) < groups   # no row of clusters is all padding
    assert mk.ring_grid(b, persistent, cluster=False) == mk.RingGrid(groups, 1, groups, persistent)
    assert fk.ring_blocks("rows", 132) == 264
    rng = np.random.default_rng(b)
    d = 40
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    qi = rng.integers(0, V, (b, NNZ_Q))
    table = torch.zeros(b, V + 1)
    table.scatter_add_(1, torch.from_numpy(qi), torch.from_numpy(rng.uniform(1, 2, (b, NNZ_Q)).astype(np.float32)))
    qg, words, tbl = fk.ring_queries(q, table, grid)
    assert qg.shape == (grid.padded, 64, 16) and words.shape[0] == tbl.shape[0] == grid.padded
    back = qg.transpose(1, 2).reshape(grid.padded * 16, 64)
    assert torch.equal(back[:b, :d], q) and not bool(back[b:].any()) and not bool(back[:, d:].any())
    dense_table = table_from_index(words, tbl, V)
    assert torch.equal(dense_table[:b], table) and not bool(dense_table[b:].any())
    # whole groups past the batch: no term present (a word's rank field counts from row 1), a zero table
    assert not bool(words[groups:, :, 0].any()) and not bool(tbl[groups:].any())
    one = fk.ring_queries(q, table, mk.ring_grid(b, persistent, cluster=False))
    assert torch.equal(one[0], qg[:groups]) and torch.equal(one[1], words[:groups])
    assert torch.equal(one[2], tbl[:groups])
