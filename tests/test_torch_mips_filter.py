"""B1's ring route (``csrc/mips_topk.cu``) through its plain emulation
(``ref.mips_filter_ref``) held against repro's B1, ``mips_topk_pallas`` run
in interpret mode as repro's own tests run it, and against repro's
reference backend.

The emulation repeats the route step for step: a sample of every
``stride``-th tile and its top k, its k-th (score, row) as each filter
block's first threshold, each block's tiles in its order with its lists
sorted down to their best k when they could overflow, and the merge of
the sample's top k, the lists and the rows past ``n_valid``.  The corpora
are small integers, so that every score is exact in f32 (and the corpus
exact in bf16) and the adversarial cases are exact too: a corpus sorted by
score, all scores equal, many ties at the threshold, NaN of both signs,
+0 and -0, n_valid below k with a valid row at -inf, a sample that covers
every row, and one that misses every good row (the lists overflow and are
sorted).  Each case runs at B = 3 and at 17, 33 and 64 queries, where the
card launches clusters of 2, 3 and 4 blocks of 16 queries over one read of
the corpus (``mips_topk.ring_grid``).  The emulation runs no cluster: at
those batches it holds the answers and the plan's block count (the CPU's
``persistent // width`` clusters), not the cluster protocol, which only
the card runs.  Tolerance: ids equal
and scores equal bit for bit, 0 ULPs (the sums are exact); the planted
random case holds ids equal and scores within ``F32_RTOL`` of the row
scale.

The NaN case is held against the reference backend only: repro's Pallas
B1 keeps its running top k by max / argmax rounds, which rank every NaN
row ahead of every number and write the canonical NaN (0xffc00000 on this
CPU), where ``lax.top_k``, the port's contract, orders NaNs by their bits
(a NaN with the sign bit set below -inf).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as jb
from repro.core.spaces import DenseSpace as JDense
from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import mips_topk as mk
from repro_torch.kernels import ref as tref

from _precision import planted_margin_corpus
from _torch_parity import assert_topk_match, np_of, to_torch

pytestmark = pytest.mark.torch

N, D, B = 2048, 8, 3


def _ints(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _sorted(rng, b):
    c, q = _ints(rng, (N, D), -2, 3), _ints(rng, (b, D), -3, 4)
    return c[np.argsort(c @ q[0], kind="stable")], q


def _equal(rng, b):
    return np.ones((N, D), np.float32), np.ones((b, D), np.float32)


def _ties(rng, b):   # a few distinct scores: hundreds of rows tie at the k-th
    return _ints(rng, (N, D), 0, 2), np.ones((b, D), np.float32)


def _nan(rng, b):    # scores <= 0 but for rows of +NaN (top) and -NaN (bottom)
    c, q = _ints(rng, (N, D), -2, 1), _ints(rng, (b, D), 1, 3)
    c[rng.choice(N, 40, replace=False), 0] = np.float32("nan")
    c[rng.choice(N, 40, replace=False), 1] = -np.float32("nan")
    return c, q


def _zeros(rng, b):  # ip: zero rows score +0 at the top; l2: rows equal to query 0 score -0
    c, q = _ints(rng, (N, D), -2, 1), _ints(rng, (b, D), 1, 3)
    c[rng.uniform(size=N) < 0.05] = 0.0
    c[7::97] = q[0]
    return c, q


def _masked(rng, b):  # n_valid < k; a valid row at -inf
    c, q = _ints(rng, (N, D), -2, 3), _ints(rng, (b, D), 1, 3)
    c[3, 0] = -np.inf
    return c, q


def _plain(rng, b):
    return _ints(rng, (N, D), -2, 3), _ints(rng, (b, D), -3, 4)


def _blind(rng, b):  # the sample's tiles score 0, every other row more: every row passes
    c, q = _ints(rng, (N, D), 1, 3), _ints(rng, (b, D), 1, 3)
    c[(np.arange(N) // 256) % 8 == 0] = 0.0
    return c, q


# name: (corpus builder, k, n_valid, plan overrides, queries)
BASE = {
    "sorted": (_sorted, 64, None, dict(stride=4, blocks=3)),
    "all equal": (_equal, 64, None, dict(stride=4, blocks=3)),
    "ties at the threshold": (_ties, 64, 2000, dict(stride=4, blocks=3)),
    "NaN of both signs": (_nan, 64, None, dict(stride=4, blocks=3)),
    "+0 and -0": (_zeros, 64, None, dict(stride=4, blocks=3)),
    "n_valid < k, a row at -inf": (_masked, 64, 40, {}),
    "the sample covers every row": (_plain, 64, 2000, {}),
    "lists overflow": (_blind, 64, None, dict(stride=8, blocks=2)),
}
CLUSTER_BATCHES = (17, 33, 64)   # clusters of 2, 3 and 4 groups on the card
CASES = {**{name: (*case, B) for name, case in BASE.items()},
         **{f"{name}, B={b}": (*case, b) for b in CLUSTER_BATCHES for name, case in BASE.items()}}


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = (mk.launches, mk.ring_launches, mk.scan_launches)
    yield
    assert (mk.launches, mk.ring_launches, mk.scan_launches) == before


def _bits(x):
    return np.asarray(np_of(x), np.float32).view(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("space", ["ip", "l2"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_repro(case, space, dtype, no_library):
    build, k, n_valid, over, b = CASES[case]
    c, q = build(np.random.default_rng(len(case)), b)
    jc = jnp.asarray(c, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    jq = jnp.asarray(q)
    tc, tq = to_torch(jc), to_torch(jq)
    nv = N if n_valid is None else n_valid
    grid = mk.ring_grid(b, mk._ring_blocks(tc, 132))
    plan = mk.filter_plan(N, nv, k, n_sms=grid.blocks, **over)
    got_s, got_i, stats = tref.mips_filter_ref(tq, tc, k, plan, n_valid=n_valid, space=space)
    # n_valid < k: repro's kernel serves the valid rows above the one at
    # -inf (its backend pads the rest); past them the port ranks the masked
    # rows (f32-min, by row) and then the -inf row, as mips_topk_ref does
    head = k if nv >= k else nv - 1
    if not case.startswith("NaN of both signs"):   # repro's Pallas B1 ranks every NaN first (see the docstring)
        want = jops.mips_topk(jq, jc, head, tile_n=512, space=space, n_valid=n_valid)
        np.testing.assert_array_equal(np.asarray(want.indices), got_i.numpy()[:, :head], err_msg=case)
        np.testing.assert_array_equal(_bits(want.scores), _bits(got_s[:, :head]), err_msg=case)
    if nv >= k:   # the reference backend masks with -inf: its tail differs below n_valid rows
        ref = jb.ReferenceBackend().topk(JDense(space), jq, jc, k, n_valid=n_valid)
        np.testing.assert_array_equal(np.asarray(ref.indices), got_i.numpy(), err_msg=case)
        np.testing.assert_array_equal(_bits(ref.scores), _bits(got_s), err_msg=case)
    # the plain version and the CPU wrapper give the same answer
    plain_s, plain_i = tref.mips_topk_ref(tq, tc, k, n_valid=n_valid, space=space)
    assert torch.equal(plain_i, got_i) and torch.equal(plain_s.view(torch.int32), got_s.view(torch.int32))
    wrap_s, wrap_i, _ = mk.mips_filter(tq, tc, k, n_valid=n_valid, space=space, **over)
    assert torch.equal(wrap_i, got_i) and torch.equal(wrap_s.view(torch.int32), got_s.view(torch.int32))
    # one group a block (the launch without clusters) gives the same answer
    one_s, one_i, _ = mk.mips_filter(tq, tc, k, n_valid=n_valid, space=space, cluster=False, **over)
    assert torch.equal(one_i, got_i) and torch.equal(one_s.view(torch.int32), got_s.view(torch.int32))
    # what the case claims about the route
    assert grid.width == (1 if b <= 16 else -(-b // 16)) and got_i.shape == (b, k)
    merged = stats[:, 1]
    assert bool((merged >= k).all())
    if case.startswith("lists overflow"):
        assert bool((stats[:, 0] > 0).all()), stats
    else:
        assert int(stats[:, 0].sum()) == 0, stats
    if case.startswith("the sample covers every row"):
        assert plan.stride == 1 and plan.blocks == 0 and plan.cols == nv
    if case.startswith("NaN of both signs"):
        assert bool(got_s.isnan().any())
    if nv < k:   # the masked rows by row id, all ahead of the valid row at -inf
        assert got_i[0, nv - 1:].tolist() == list(range(nv, k + 1)) and 3 not in got_i[0].tolist()


@pytest.mark.parametrize("k,n_valid,over", [(1, None, {}), (10, 1900, dict(stride=3, blocks=5)),
                                            (300, None, dict(stride=2, blocks=4)),
                                            (64, 0, {}), (600, 500, dict(stride=2))])
def test_emulation_random_planted(k, n_valid, over, no_library):
    q, c, _ = planted_margin_corpus(N, 16, 4, min(k, 64), seed=k)
    tq, tc = to_torch(q), to_torch(c)
    nv = N if n_valid is None else n_valid
    plan = mk.filter_plan(N, nv, k, n_sms=132, **over)
    got_s, got_i, stats = tref.mips_filter_ref(tq, tc, k, plan, n_valid=n_valid)
    want_s, want_i = tref.mips_topk_ref(tq, tc, k, n_valid=n_valid)
    assert torch.equal(want_i, got_i) and torch.equal(want_s.view(torch.int32), got_s.view(torch.int32))
    if k <= 64 and nv >= k:
        assert_topk_match(jops.mips_topk(q, c, k, tile_n=512, n_valid=n_valid), (got_s, got_i), ctx=k)
    assert bool((stats[:, 1] >= plan.k_sample + plan.masked).all())   # the sample's list and the masked rows


PLAN_SHAPES = [(8_841_823, 8_841_823, 10), (8_841_823, 8_841_823, 100), (8_841_823, 8_841_823, 2048),
               (8_841_823, 8_800_000, 2000), (2973, 2973, 64), (300, 200, 290), (5000, 0, 7)]
# the cluster grid's batches: one group, one group and a query, 2 to 8 groups, and two rows of clusters
GRID_BATCHES = (1, 15, 16, 17, 32, 33, 64, 65, 128, 129, 200)


@pytest.mark.parametrize("n,n_valid,k,b", [pytest.param(*shape, 16, id="-".join(map(str, shape)))
                                           for shape in PLAN_SHAPES]
                         + [(8_841_823, 8_841_823, 100, b) for b in GRID_BATCHES]
                         + [(2973, 2973, 64, b) for b in GRID_BATCHES])
def test_filter_plan(n, n_valid, k, b, monkeypatch):
    grid = mk.ring_grid(b, 132)
    p = mk.filter_plan(n, n_valid, k, n_sms=grid.blocks)
    tiles = -(-n_valid // mk.TILE)
    assert 1 <= p.stride <= mk.SAMPLE_STRIDE
    assert p.slots >= k + mk.TILE and p.slots & (p.slots - 1) == 0
    assert p.k_sample == (p.cols if p.stride == 1 else min(k, p.cols)) and p.masked == min(k, n - n_valid)
    sampled = -(-tiles // p.stride)
    assert p.blocks == min(grid.blocks, tiles - sampled) and p.sample_blocks == min(grid.blocks, sampled)
    # the grid: G groups of 16, clusters of at most 8 in ceil(G / 8) rows, each row reading the corpus once;
    # the clusters of a row that fit 132 SMs along x (one block an SM)
    groups = -(-b // 16)
    rows = -(-groups // 8)
    assert (grid.groups, grid.rows) == (groups, rows if groups > 1 else 1)
    assert grid.width == (1 if groups == 1 else -(-groups // rows)) and grid.width <= mk.MAX_CLUSTER
    assert groups <= grid.padded < groups + grid.rows and grid.padded == grid.rows * grid.width
    assert grid.blocks == 132 // grid.width
    reads = {1: 1, 15: 1, 16: 1, 17: 1, 32: 1, 33: 1, 64: 1, 65: 1, 128: 1, 129: 2, 200: 2}[b]
    assert grid.rows == reads   # the corpus reads of one launch
    # without clusters: a block a group, G reads, the persistent blocks along x (today's launch at one group)
    one = mk.ring_grid(b, 132, cluster=False)
    assert one == mk.RingGrid(groups, 1, groups, 132)
    assert mk.ring_grid(b, 2 * 132).blocks == 2 * 132 // grid.width   # the row layout: two blocks an SM
    # the buffers' shapes at this batch: the lists [B, blocks, slots] and counts [B, blocks]
    monkeypatch.setattr(mk, "_sms", lambda dev: 132)   # the selection's shape, on the meta device
    buf = mk.filter_buffers(b, k, p, torch.device("meta"))
    assert buf.lists.shape == (b, p.blocks, p.slots) and buf.counts.shape == (b, p.blocks)
    assert buf.sample.shape == (b, p.cols) and buf.out_s.shape == (b, k) and buf.stats.shape == (b, 2)
    # the sample's rows: every stride-th tile below n_valid
    rows = np.arange(n_valid)
    assert p.cols == int(((rows // mk.TILE) % p.stride == 0).sum()) if n_valid < 10**6 else p.cols > 0
    if n_valid >= mk.SAMPLE_PER_K * k * mk.SAMPLE_STRIDE:
        assert p.stride == mk.SAMPLE_STRIDE and p.cols >= mk.SAMPLE_PER_K * k
    if n_valid < mk.SAMPLE_PER_K * k * 2:   # a small corpus is all sample
        assert p.stride == 1 and p.blocks == 0 and p.cols == n_valid
    # memory at B = 16: the sample's scores and the lists, under 0.25 GB at full scale
    assert 16 * (4 * p.cols + 8 * p.blocks * p.slots) < 0.25e9
